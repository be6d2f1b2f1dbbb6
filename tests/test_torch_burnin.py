"""The port's burn-in against the JAX package's, on the CPU: the same
parameters and data (the JAX side's, carried across by ``convert``) trained
for a few SGD steps on a 2 × 2 dp × tp mesh (the JAX side on the 8-device
CPU mesh, the port in a gloo world of four) give each step's loss within
1e-5 relative and the final parameters within 1e-4."""

import numpy as np
import pytest

from tpu_operator_torch import convert
from tpu_operator_torch.workloads import burnin, mesh

N = 4
STEPS = 3
SIZES = {"batch": 16, "d_model": 32, "d_hidden": 64}
WORLD_TIMEOUT_S = 120


def _burnin_cases(world, params, data):
    """Every case of this module on one rank: ``STEPS`` steps on the
    reference's inputs (losses and the final shards), and the probe on the
    port's own inputs."""
    m, train_step, p, (x, y) = burnin.build_burnin(world, params=params, data=data, **SIZES)
    losses = []
    for _ in range(STEPS):
        p, loss = train_step(p, x, y)
        losses.append(float(loss))
    return {
        "mesh": (m.dp, m.tp),
        "losses": losses,
        "final": {k: convert.to_numpy(v) for k, v in p.items()},
        "probe": burnin.rank_burnin(world, steps=5, sizes=SIZES),
    }


@pytest.fixture(scope="module")
def cases():
    from tpu_operator.workloads.burnin import build_burnin

    jmesh, train_step, params, (x, y) = build_burnin(n_devices=N, **SIZES)
    np_params = {k: np.asarray(v) for k, v in params.items()}
    data = (np.asarray(x), np.asarray(y))
    losses = []
    for _ in range(STEPS):
        params, loss = train_step(params, x, y)
        losses.append(float(loss))
    port = mesh.spawn_world(
        _burnin_cases, N, "cpu", np_params, data, timeout_s=WORLD_TIMEOUT_S
    )
    return {
        "jmesh": jmesh,
        "params0": np_params,
        "data": data,
        "losses": losses,
        "final": {k: np.asarray(v) for k, v in params.items()},
        "port": port,
    }


def test_mesh_is_the_references(cases):
    assert all(c["mesh"] == tuple(cases["jmesh"].devices.shape) for c in cases["port"])


@pytest.mark.parametrize("step", range(STEPS))
def test_each_steps_loss_matches_the_reference(cases, step):
    want = cases["losses"][step]
    for c in cases["port"]:
        assert abs(c["losses"][step] - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("name", ["w1", "w2"])
def test_final_params_match_the_reference(cases, name):
    dp, tp = mesh.mesh_shape(N)
    axis = 1 if name == "w1" else 0
    # each tp column of the mesh holds one block; every dp row a copy of it
    for d in range(dp):
        blocks = [cases["port"][d * tp + t]["final"][name] for t in range(tp)]
        got = np.concatenate(blocks, axis=axis)
        assert got.shape == cases["final"][name].shape
        assert float(np.abs(got - cases["final"][name]).max()) <= 1e-4
    assert cases["losses"][-1] < cases["losses"][0]


@pytest.mark.parametrize("rank", range(N))
def test_shards_are_the_named_shardings(cases, rank):
    """``convert.burnin_shards`` gives rank r what the reference's
    NamedSharding puts on mesh device r."""
    import jax

    from tpu_operator.workloads.burnin import build_burnin

    jmesh, _, params, (x, y) = build_burnin(n_devices=N, **SIZES)
    device = jmesh.devices.reshape(-1)[rank]
    dp, tp = mesh.mesh_shape(N)
    mine, (xs, ys) = convert.burnin_shards(cases["params0"], cases["data"], dp, tp, rank)
    for name, arr in (("w1", params["w1"]), ("w2", params["w2"]), ("x", x), ("y", y)):
        shard = next(s for s in arr.addressable_shards if s.device == device)
        want = np.asarray(jax.device_get(shard.data))
        got = {"x": xs, "y": ys}.get(name, mine.get(name))
        assert got.tobytes() == want.tobytes(), name


def test_probe_on_its_own_inputs_decreases_the_loss(cases):
    res = cases["port"][0]["probe"]
    assert res.ok and res.loss_decreased, res.error
    assert res.mesh_shape == (2, 2) and res.n_devices == N and res.steps == 5
    assert np.isfinite(res.final_loss)
    assert all(c["probe"] == res for c in cases["port"])


def test_result_to_dict_keys_match():
    from tpu_operator.workloads.burnin import BurninResult

    args = (True, 4, (2, 2), 10, 0.5, True)
    assert burnin.BurninResult(*args).to_dict() == BurninResult(*args).to_dict()
