"""Multi-card slice burn-in: a dp × tp training step over a world of ranks.

The counterpart of the JAX package's ``workloads/burnin.py``. A slice is
only healthy if every card computes and every link carries collectives:
this burn-in runs a real train step of a two-layer gelu MLP whose
tensor-parallel product is summed over ``tp`` and whose gradient is summed
over ``dp``, so every axis of the mesh carries traffic each step.

Layout, as the reference's ``NamedSharding``: rank ``r`` sits at
``(r // tp, r % tp)`` of the ``dp`` × ``tp`` mesh (``mesh.mesh_shape``);
``w1`` is column-parallel over ``tp``, ``w2`` row-parallel, the batch is
sharded over ``dp``. The reference lets XLA insert the collectives; here
they are explicit:

* the forward pass sums the ``tp`` ranks' partial outputs with an
  all-reduce whose backward pass is the identity (``_TpSum``): the loss is
  replicated across ``tp``, so reducing the gradient too would multiply it
  by ``tp``;
* the loss is the mean over the global batch × ``d_model``: each rank's
  local sum over that global count, summed over ``dp``; so is each weight
  shard's gradient, after which SGD (lr 0.05) updates it.

Used by ``python -m tpu_operator_torch.validator --component slice`` and
``entry.dryrun_multichip``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_operator_torch import convert
from tpu_operator_torch.device import resolve_device
from tpu_operator_torch.workloads.mesh import (
    Rank,
    dp_tp_groups,
    mesh_shape,
    spawn_world,
    world_size,
)

LR = 0.05


@dataclass
class BurninResult:
    ok: bool
    n_devices: int
    mesh_shape: Tuple[int, int]
    steps: int
    final_loss: float
    loss_decreased: bool
    error: str = ""

    def to_dict(self):
        return {
            "ok": self.ok,
            "n_devices": self.n_devices,
            "mesh_shape": list(self.mesh_shape),
            "steps": self.steps,
            "final_loss": round(self.final_loss, 6),
            "loss_decreased": self.loss_decreased,
            "error": self.error,
        }


@dataclass(frozen=True)
class BurninMesh:
    """The rank's place on the ``dp`` × ``tp`` mesh and its two groups."""

    dp: int
    tp: int
    dp_group: object
    tp_group: object


class _TpSum(torch.autograd.Function):
    """Sum over the ``tp`` group in the forward pass, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def burnin_inputs(batch: int, d_model: int, d_hidden: int):
    """``(params, (x, y))`` as numpy f32 global arrays, drawn from a
    generator seeded 42 (the reference's key; its values differ)."""
    gen = torch.Generator().manual_seed(42)
    w1 = torch.randn((d_model, d_hidden), generator=gen) * (1.0 / d_model**0.5)
    w2 = torch.randn((d_hidden, d_model), generator=gen) * (1.0 / d_hidden**0.5)
    x = torch.randn((batch, d_model), generator=gen)
    # a fixed random target makes the loss strictly decreasing under SGD
    y = torch.randn((batch, d_model), generator=gen)
    return {"w1": w1.numpy(), "w2": w2.numpy()}, (x.numpy(), y.numpy())


def build_burnin(
    world: Rank,
    batch: int = 32,
    d_model: int = 256,
    d_hidden: int = 512,
    params: Optional[dict] = None,
    data: Optional[tuple] = None,
):
    """Construct (mesh, train step, this rank's params, its data).

    ``params`` (``{"w1", "w2"}``) and ``data`` (``(x, y)``) are the
    reference's global numpy arrays; by default ``burnin_inputs`` draws
    them. ``train_step(p, x, y)`` returns ``(new_p, loss)``, the loss being
    the global mean the step's gradient was taken of."""
    dp, tp = mesh_shape(world.size)
    if params is None or data is None:
        params, data = burnin_inputs(batch, d_model, d_hidden)
    mine, (x, y) = convert.burnin_shards(params, data, dp, tp, world.rank)
    dev = world.device
    mine = {k: convert.to_torch(v, dev) for k, v in mine.items()}
    x, y = convert.to_torch(x, dev), convert.to_torch(y, dev)
    mesh = BurninMesh(dp, tp, *dp_tp_groups(world, dp, tp))
    count = float(data[0].shape[0] * data[1].shape[1])

    def train_step(p, xb, yb):
        p = {k: v.detach().requires_grad_() for k, v in p.items()}
        h = F.gelu(xb @ p["w1"], approximate="tanh")
        out = _TpSum.apply(h @ p["w2"], mesh.tp_group)
        loss = ((out - yb) ** 2).sum() / count
        loss.backward()
        new_p = {}
        for k, w in p.items():
            dist.all_reduce(w.grad, group=mesh.dp_group)
            new_p[k] = (w - LR * w.grad).detach()
        loss = loss.detach()
        dist.all_reduce(loss, group=mesh.dp_group)
        return new_p, loss

    return mesh, train_step, mine, (x, y)


def rank_burnin(world: Rank, steps: int = 20, sizes: Optional[dict] = None) -> BurninResult:
    """The rank's part of ``run_burnin`` (``sizes`` are ``build_burnin``'s
    keywords); every rank returns the same result."""
    mesh, train_step, params, (x, y) = build_burnin(world, **(sizes or {}))
    losses = []
    for _ in range(steps):
        params, loss = train_step(params, x, y)
        losses.append(float(loss))
    return BurninResult(
        ok=losses[-1] < losses[0],
        n_devices=world.size,
        mesh_shape=(mesh.dp, mesh.tp),
        steps=steps,
        final_loss=losses[-1],
        loss_decreased=losses[-1] < losses[0],
    )


def run_burnin(
    n_devices: Optional[int] = None,
    steps: int = 20,
    device: Optional[str] = None,
    **kw,
) -> BurninResult:
    """``steps`` train steps on a world of ``n_devices`` ranks (every card
    by default); ``kw`` are ``build_burnin``'s sizes. On ``cuda`` unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    try:
        n = world_size(n_devices, dev)
        return spawn_world(rank_burnin, n, dev, steps, kw)[0]
    except Exception as e:
        return BurninResult(
            ok=False,
            n_devices=0,
            mesh_shape=(0, 0),
            steps=steps,
            final_loss=float("nan"),
            loss_decreased=False,
            error=str(e),
        )

