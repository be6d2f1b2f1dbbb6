#!/usr/bin/env python3
"""Drive the PyTorch port's compute chain on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one H100 and the
CUDA toolkit (``nvcc``). Phases, in order; any failure exits non-zero:

1. print the card (``nvidia-smi`` name and power limit), torch and nvcc
   versions, build the kernels from ``tpu_operator_torch/csrc`` (ptxas's
   registers and spills printed; a ``wgmma`` serialization note, C7515 or
   C7519, fails), and count ``HGMMA``, ``UTMALDG`` and ``HMMA`` in the SASS
   of each of the eight instances of the Hopper kernel, K3, K4, K5, K6a,
   K6b, K7a, K7b and K7c (``cuobjdump``; a missing instance, no HGMMA or
   UTMALDG, any HMMA in any function of the library, or a ``MUFU.EX2`` in
   K6a or K6b, whose softmax is gone, fails); then build the native
   programs with ``g++`` (``native/build.py``), so that phases 6-9 and
   the CLI read the chip table through ``libgpuinfo.so``;
2. first, under a watchdog of ``PARTIAL_TILE_TIMEOUT_S`` (a wrong TMA
   transaction count on a box that reaches past seq would hang a kernel),
   every flash kernel at ``PARTIAL_TILE_SHAPES``, seqs its blocks do not
   divide, against its plain version at the same tiling (K6b only where
   ``block_k`` >= 128, the structural modes only causal), with the bit
   identities K4 == K3, K7a == K3 and K7c == K7b; then hold each kernel
   against its plain PyTorch version on the card (the
   copies bit-exact, and K1's tried Hopper design, ``tiled_copy_tma``,
   timed beside K1; flash attention K3 and the variants K4 ``pipelined``
   and K5 ``bf16exp`` within 1e-2 of their plain versions and within 2e-2
   of the f32 oracle, also at the edges of the Hopper kernel
   (``K3_EDGE_SHAPES``) and, for K4 and K5, at 1 x 512 with 64/64 blocks,
   where some q-blocks have an odd number (3, 5, 7) of unmasked
   sub-tiles, K4 equal to K3 bit for bit at every shape; the
   instruments K6a ``softmax_stub`` within 1e-2 and K6b ``qk_only``
   within one bf16 ulp of theirs, also at those edges, K6b where
   ``block_k`` >= 128), check that all eight Hopper instances refuse
   ``block_q`` 32 with ``ValueError`` and launch nothing and that the host
   cost per call of each stays within ``K3_HOST_LIMIT_US`` of a launch that
   encodes no tensor map (K1 on a small buffer), and time kernel, plain
   version and one library call at the main path's shapes;
3. hold one step of the matmul chain at size 1000, where ``1/size`` is no
   power of two, against the host's f32 product, scaled and then rounded
   to bf16 once (each element within one bf16 ulp and the f32 sum's
   reordering, at most ``MATMUL_MISS_SHARE`` of them off); run the main path in-process at its
   full operating points (matmul 8192, membw 2 GiB, flash attention 8192 x
   8 heads) with the launch counts set to 0 just before and read just
   after; then, each counted apart, the
   flash probe with the card's default blocks at seq 4160, which must run
   64/64, and at seq 8200, which must run 128/128 with a partial last
   block, each launching K3 and passing the oracle;
3b. run the flash-attention attribution path the same way: the bench's
   ``run_flashattn_breakdown(seq=8192, heads=8, iters=16)`` and the
   ``bf16exp`` probe at 8192 x 8 heads, each of K3-K6b launched; then,
   counted apart, ``fa_variant_check`` (K3 against K4, each launched, its
   median ratio and IQR logged, no limit);
3c. the structural-variant path: hold K7a ``paired``, K7b ``bf16s`` and
   K7c ``paired16`` against their plain versions (within 1e-2, and nearer
   in mean-abs to their own softmax's plain version than to the other's;
   K7b and K7c never equal to K3) and the f32 oracle (2e-2) at the
   variants' causal shapes, at the causal edges of the Hopper kernel, at
   1 x 512 with 64/64 blocks and at 8 x 8192, K7a equal to K3 and K7c
   equal to K7b bit for bit; then, with the launch counts set to 0 just
   before and read
   just after, run ``run_experiment`` with all three modes at 8192 x 8
   heads, each of K7a-c launched; then time K7a-c;
5. (after 3c, before 4) the multi-device path on every card
   (``torch.cuda.device_count()`` ranks, NCCL, one process a card):
   ``run_burnin`` (10 steps), ``run_ring_probe``, ``run_ringattn``,
   ``run_pipeline`` and ``run_moe`` at the validator's full widths, each
   of which must be ``ok``, in one JSON line with each result and its wall
   time, then the burn-in's seconds a step, the card's name and power
   limit and ``entry.dryrun_multichip``; this path launches none of
   K1-K7c;
6. (after 5, before 4) the node agents: the chip table
   (``native/gpuinfo.py``), which must come from NVML and agree with torch
   (by PCI bus id where both give one, else by count) and with
   ``nvidia-smi`` (name, power limit); ``device_probe_path`` on every
   ``/dev/nvidiaN``; the /dev/char links made into a temporary directory,
   one ``195:<minor>`` a card; the ``driver`` and ``toolkit`` CLI
   components (the toolkit on the host's JSON CDI spec, else on one
   written from the chip table); ``validate_vfio_pci``, which must refuse
   and name the cards' PCI functions and no NVSwitch; one
   ``MetricsDaemon(own_chip=True).collect_once()`` (``tensorcore_util`` in
   (0, 100]) and one GET of its HTTP endpoint; the workload pods' matmul,
   device-count and gang scripts as subprocesses (the gang from the env
   ``slice_gang_pod`` builds; a gang of two with two or more cards); one
   pass of each ``NodeMetrics`` watcher; this path launches none of
   K1-K7c;
7. (after 6, before 4) the card advertised to the kubelet, on every card:
   ``runtime_wire.wire_once`` writes the CDI spec from NVML's chip table
   and the ``toolkit`` CLI component passes on it; the device plugin
   (over gRPC on a unix socket where grpc and protobuf import, else
   through the servicer's plain-data methods, which the log says) first
   advertises exactly the chip table's ids, all ``Healthy``, streams a
   card's ``mark_unhealthy`` and ``mark_healthy``, answers
   ``GetPreferredAllocation`` with offered ids only (1 card, and with two
   or more cards 2 with one must-include), and ``Allocate`` with CDI
   names of the spec's devices and an env naming the cards by UUID; a
   process with that env sees exactly the allocated cards' UUIDs (one
   allocation, two with two or more cards); the port's
   ``KubeletDeviceManager`` registers a fresh plugin over gRPC and writes
   the node's capacity into a ``FakeClient`` node (without grpc the script
   writes the advertisement's), and the ``plugin`` component passes on it
   (``plugin-ready`` 1 in the node-status readiness); feature discovery's
   product, count, memory and driver-version labels equal ``nvidia-smi``'s; the plugin's
   first-advertisement time, each ``Allocate`` round trip and the phase's
   wall time are logged; this path launches none of K1-K7c;
8. (after 7, before 4) the node's partition and telemetry operands, on
   every card, in a temporary directory: the slice manager on a node that
   feature discovery labelled from NVML's chip table (the port's
   ``FakeClient``, whose stale write answers 409), one slice a card
   and, with two or more cards, 1x2: each reconcile ``success``, the
   subslices cover exactly the chip table's minors inside one NVLink
   domain each, the CDI composites hold exactly their cards' nodes and
   ``PluginManager(strategy="mixed")`` advertises one
   ``nvidia.com/mig-<shape>`` device a subslice, while a shape that does
   not tile the host ends ``failed``; the exporter over NVML idle and
   under ~1 s of ``torch.mm`` (every series' source printed; presence 1,
   duty cycle in [0, 100], memory in use at most NVML's total, memory in
   all the variant's), through the metrics daemon's sampler
   (``tensorcore_util`` as ``sampler``) and, where prometheus_client
   imports, ``/metrics``; the driver installer from the machine's own
   libraries into a temporary driver root (the ``driver`` component
   passes on it, ``VERSION`` is NVML's version, after ``uninstall`` the
   component fails); the driver manager on the store (the pod that
   requests a card evicted, the five barriers cleared; the same
   ``FakeClient``); the vfio manager
   and the vm, vm-device and kata managers on fixture trees only, and the
   cards' MIG mode printed; this path launches none of K1-K7c;
9. (after 8, before 10) the native programs, on every card: their build
   (``g++ --version`` and seconds logged); ``gpu_smoke --json`` exits 0
   with ``torch.cuda.device_count()`` cards whose names are
   ``nvidia-smi``'s, and exits 2 on an empty ``--dev-root`` with an NVML
   that does not answer; the native chip table equal to the ``ctypes``
   table on the identity fields (every card ``nvml``), its counters
   present alike and in range, one call of each timed in turns, and the
   native device probe equal to the Python one on every card's node;
   ``python -m tpu_operator_torch.metricsd --port 0`` execs the
   hostengine (``/json`` names it), which merges the side file the port's
   sampler wrote on cuda:0 (``tensorcore_util`` in (0, 100], ``sampler``),
   drops it when stale (``gpu_metricsd_sample_fresh 0``), publishes a drop
   file read back through ``libgpuinfo`` and stops on SIGTERM, while
   ``--no-native`` serves from Python; ``run_telemetry_chain`` with the
   sampler's reading while products run on cuda:0 is ``ok``, with
   ``tensorcore_util`` from the sampler and ``duty_cycle`` above 0 from
   NVML (every series' source printed); the /json GET's ms and the
   phase's wall time logged; this path launches none of K1-K7c;
10. (after 9, before 4) the control plane's foundation, under a
   watchdog of ``CONTROL_PLANE_TIMEOUT_S``: ``python -m
   tpu_operator_torch.cfg generate crd`` gives the generated CRD and
   ``validate clusterpolicy`` passes the port's sample and fails (rc 1,
   naming the field) a copy with an enum violated; KubeSim on loopback
   registers the CRD, stores the sample created through the
   ``RestClient`` as ``default_cr`` of it and answers the violated copy
   with 422; the card's node, labelled by feature discovery (product,
   count, memory and driver version equal to ``nvidia-smi``'s), joins
   ``FLEET_NODES - 1`` simulated GPU nodes, a paged LIST (limit
   ``LIST_PAGE``) returns every node once and a label-selector LIST the
   card's node alone; the device plugin over the real cards registers over
   gRPC with the port's ``KubeletDeviceManager``, which writes through a
   ``RestClient`` into KubeSim, and a ``RestClient`` watch must deliver
   capacity and allocatable equal to the chip table's card count
   (``mark_unhealthy`` one less allocatable, ``mark_healthy`` back); the
   ``plugin`` component passes over the ``RestClient``;
   ``kubelet.allocate`` runs the kubelet's preference-then-Allocate
   sequence and a process with the answer's env sees exactly that card;
   the CR admission, paged-LIST, watch-event and phase times and the
   card's name and power limit are logged; grpc is required (no plain-data
   fallback); this path launches none of K1-K7c;
11. (after 10, before 4) the control plane's read and write paths, under a
   watchdog of ``READ_WRITE_TIMEOUT_S``, on one KubeSim over loopback:
   ``testing.seed_cluster`` writes the port's CRD and sample, the card's
   node (feature discovery's labels) joins ``FLEET_NODES - 1`` simulated
   nodes; a ``CachedClient`` over a ``RestClient`` syncs every default
   kind (each kind's sync time logged), then a get, a label-selector LIST
   and a LIST of every node issue zero HTTP requests and a foreign write
   reaches the cache through its watch; the device plugin registers with
   the port's ``KubeletDeviceManager`` and the cache's event hook sees
   the chip table's card count as capacity and allocatable (one less
   after ``mark_unhealthy``); ``EVENT_REPEATS`` records of one capacity
   change store one Event whose count is true once past the
   correlator's window, the coalesced ones issuing no request, and a
   second reason with ``dedup_extra`` is stored apart; one label on every
   node through ``WritePipeline`` at each of ``PIPELINE_DEPTHS`` and
   through a ``BatchLane`` (two revisions of one key landing in order),
   every node carrying the last value in the cache; a ``WarmJournal``
   saved from the cache seeds a second one that starts with no LIST and
   sees a node changed while it was down; ``simulate_kubelet_nodes`` over
   one OnDelete driver DaemonSet (``consts.DRIVER_APP``) puts one Running
   pod at the template hash on each node its ``nodeSelector`` names, a
   template change leaves them alone, and the node agents' role writes
   the card variant's datasheet rates; ``OperatorMetrics`` (
   ``prometheus_client`` is required) counts the pipeline's queue waits
   and each write verb's round trips; the times and the card's name and
   power limit are logged; this path launches none of K1-K7c;
12. (after 11, before 4) the state machine on the card's node, under a
   watchdog of ``STATE_MACHINE_TIMEOUT_S``, on one KubeSim over loopback:
   ``testing.seed_cluster`` writes the port's CRD and sample (the other
   H100 variant's driver pinned in ``generationConfigs``), the card's node
   (feature discovery's labels) joins ``FLEET_NODES - 1`` nodes, of them
   ``OTHER_VARIANT_NODES`` of the other variant and ``CPU_NODES`` without
   a card; a ``ClusterPolicyController`` over a ``CachedClient`` with the
   package's own assets (``run_state_machine``) labels the card's node
   (present, the container workload's deploy labels, the variant
   ``device_generation`` gives) and no CPU node; ``run_states`` with
   ``simulate_kubelet_nodes`` between passes reads every enabled state
   READY within ``MAX_PASSES``, every DaemonSet named by ``OPERAND_APPS``,
   one driver DaemonSet a variant, the sandbox states off; a second pass
   issues no write request and renders nothing; disabling the exporter
   deletes its DaemonSet, a ``spec.driver.version`` edit moves only the
   card variant's driver hash, a rolled-back ledger pins the previous
   version; ``gang_epoch`` and a workload pod's owner find
   ``gpu-operator-validator``; the card's slice reads READY with the
   device plugin's cards and NOT_READY once every card is unhealthy; the
   init, label fan-out, passes to READY and steady-pass times and the
   card's name and power limit are logged; this path launches none of
   K1-K7c;
13. (after 12, before 4) the node FSMs on the card's node, under a
   watchdog of ``NODE_FSMS_TIMEOUT_S``, on one KubeSim over loopback with
   ``FSM_FLEET_NODES`` nodes: the card's node (feature discovery's labels
   and the slice labels of a 4-host deployment) is one host of
   ``slice-card`` beside 3 simulated members, 7 more 4-host slices,
   ``FSM_SOLO_NODES`` single-host nodes of the other H100 variant and
   ``FSM_CPU_NODES`` CPU nodes; the device plugin over the real cards
   serves the card's node; a ``ClusterPolicyController`` over a
   ``CachedClient`` converges the operands (``run_node_fsms``). Three
   walks through the cache: a ``spec.driver.version`` edit under an
   ``upgradePolicy`` (``maxParallelUpgrades`` ``FSM_FLEET_NODES``,
   ``maxUnavailable`` 25%, drain on) rolls every GPU node to
   ``upgrade-done`` within ``MAX_FSM_PASSES`` passes of
   ``ClusterUpgradeStateManager``, the card's node through every state in
   order, cordoned from ``cordon-required`` until its slice uncordons
   together, its workload pod (cards from ``kubelet.allocate``) evicted
   through the eviction subresource, its driver pod recreated at the new
   hash, its previous version recorded from ``DRIVER_VERSION_LABEL``, the
   four members of ``slice-card`` active in the same passes, at most 25%
   of the slices disrupted in any pass, a PodDisruptionBudget pinning a
   second slice in ``drain-required`` until it is deleted, no CPU node
   labelled, and one more pass writing nothing; remediation
   (``backoffSeconds`` 0) takes the card's node, every card marked
   unhealthy, through the restart rung (its ``gpu-*`` operand pods
   deleted, a ``user-job`` pod left) to quarantine (cordon, repair taint
   and label), touching no other node, and back to ``recovered`` once the
   cards are healthy; the re-partition roll to ``all-1x1`` admits
   ``slice-card`` (remediation then skips the card's node), the port's
   ``SliceManager`` applies it on the card's node over the KubeSim
   client, and every GPU node ends on the layout; the passes and times and
   the card's name and power limit are logged; this path launches none of
   K1-K7c;
14. (after 13, before 4) the reconcilers on the card's node, under a
   watchdog of ``RECONCILERS_TIMEOUT_S``. On a KubeSim with ``FLEET_NODES``
   nodes (the card's node one host of ``slice-card``, ``RECONCILE_SLICES``
   4-host slices of its variant, ``RECONCILE_SOLOS`` single hosts of the
   other, the rest CPU nodes; the device plugin over the real cards
   serving the card's node), a ``ClusterPolicyReconciler`` over a
   ``CachedClient`` (``run_reconcile_pass``) reaches ``Result.ready`` with
   every slice ready within ``MAX_RECONCILE_PASSES`` (``status.state``
   ``ready``, ``status.slices`` one unit a 4-host slice or single host, the
   ``Ready`` condition true, one Normal ``Ready`` Event, no CPU node
   labelled); five traced steady passes and one scoped pass issue 0 write
   requests and record the six span names of the pass; the predicate
   ``node_event_needs_reconcile`` over the cache's ``(old, new)`` wakes on
   one card marked unhealthy and on a product-label edit, not on another
   label; an ``EventRouter`` fed by the cache's event hook routes the card's
   validator going not-ready to ``("slice", "slice-card")`` alone, and
   ``reconcile_slice`` lowers ``status.slices.ready`` by one and labels the
   slice's hosts false without a full pass, then restores both. On a second
   KubeSim of ``ROLLOUT_SLICES`` 4-host slices (``run_rollout``; a tick is
   a full pass, a kubelet sweep and an ``UpgradeReconciler`` pass, at most
   ``MAX_ROLLOUT_TICKS``), a clean driver roll under ``ROLLOUT`` reaches
   ``complete`` with 2 promotions, ``status.rollout`` mirroring the ledger,
   every node's previous version recorded and the card's driver pod
   recreated at the new hash, at most 25% of slices disrupted in any tick;
   a registered bad version is rolled back from its canary, no slice
   outside it admitted, with one Warning Event naming the evidence and one
   flight dump; the times and the card's name and power limit are logged;
   this path launches none of K1-K7c;
15. (after 14, before 4) the operator process on the card's node, under a
   watchdog of ``OPERATOR_TIMEOUT_S``. The shipped ``python -m
   tpu_operator_torch.main --kubesim --simulate-kubelet --once`` exits 0 at
   ``--nodes`` 1 and 256 (its wall time is the port's ``time_to_ready_s``),
   2 without ``--simulate-kubelet``, and 0 with ``--grpc-kubelet``, its
   node advertising ``nvidia.com/gpu`` equal to the card count. On a
   KubeSim with the ``FSM_FLEET_NODES``-node fleet of phase 13 (the device
   plugin over the real cards serving the card's node), the whole operator
   (``build_manager`` with probe and debug endpoints, ``wire_event_sources``,
   the manager's workers, through ``running_operator``) reaches READY;
   ``/healthz`` answers ok and ``/debug/vars`` holds ``DEBUG_VARS_KEYS`` with
   sharding off; a window of ``STEADY_WINDOW_S`` writes nothing; a deploy
   label deleted from the card's node comes back by a delta node pass
   through the workqueue and no full pass; every card unhealthy turns
   ``slice-card`` not ready in ``status.slices``, healthy again ready. On a
   second KubeSim of ``FAILOVER_SLICES`` 4-host slices, two managers with
   leader election hand ``gpu-operator-leader`` over when the holder stops,
   and two replicas with ``GPU_SHARDS=2`` split ``gpu-operator-shard-0/1``;
   the shard-0 holder stops without releasing its lease and the survivor
   owns both, confirms shard 0 live and runs its full pass with the CR
   READY; the times and the card's name and power limit are logged; this
   path launches none of K1-K7c;
16. (after 15, before 4) allocation churn and the chaos soak beside the
   card's node, under a watchdog of ``CHURN_TIMEOUT_S``. On a KubeSim of
   ``FLEET_NODES`` nodes, the card's node (the device plugin over the real
   cards serving it) and synthetic H100 NVL hosts of four NVLink-bridged
   pairs, the whole operator runs with the kubelet sweep while a
   ``schedsim`` ``ChurnEngine`` pushes ``CHURN_RATE`` allocations a minute
   (``CHURN_WORKERS`` workers, gangs of ``CHURN_GANG_HOSTS`` whole hosts at
   ``CHURN_GANG_FRACTION``) through the plugin admission path, its agent
   for the card's node over the real servicer (``run_alloc_churn``). At
   READY the cards of the card's node and of one synthetic host die;
   remediation turns active; churn goes on ``CHURN_HOLD_S``; the cards
   recover and the fleet is READY again; the churn lasts at least
   ``CHURN_WINDOW_S``. Allocations land on the card's node, each naming
   card ids ``gpuinfo.chip_summary`` lists, by CDI name and UUID, none
   while its cards are unhealthy; no synthetic host names a device node
   that exists or asks for a chip table; the drain holds 0 cards and 0
   pods, with 0 double allocations and 0 partial gangs. Then
   ``tests/test_chaos_soak.py``'s bad-version soak (``SOAK``) under the
   port's lock-order watchdog (``run_soak``) rolls back from its canary
   with every assertion of the reference's test and no lock-order cycle.
   Rates, latencies, fragmentation and times are logged beside the card's
   name and power limit; this path launches none of K1-K7c;
17. (after 16, before 4) the static analyser and the two e2e drivers, under
   a watchdog of ``LINT_E2E_TIMEOUT_S``. ``python -m
   tpu_operator_torch.analysis --repo-root <the script's tree>`` reports 0
   findings with rc 0 twice, byte-identical, and the scan is timed in
   process; ``SEEDED_GUARDED_BY`` in a temporary root with its own
   ``[tool.gpu_analysis]`` section gives rc 1 and its one finding. ``python
   -m tpu_operator_torch.e2e.http_e2e`` (KubeSim over HTTP, the production
   ``RestClient``, the ``gpu-maintenance-handler`` window among its steps)
   exits 0 with ``HTTP-E2E PASSED``; ``e2e.fake_e2e.main()`` returns 0 with
   its four parallelism probes on the cards over NCCL, each ``*-ready``
   file ok over every card. The times are logged beside the card's name
   and power limit; this path launches none of K1-K7c;
18. (after 17, before 4) the reference's fault, remediation, multi-host
   slice, chaos and alert-rule suites with the card's node in the fleet,
   under a watchdog of ``RESILIENCE_TIMEOUT_S``, each scenario on its own
   KubeSim with the device plugin over the real cards serving the card's
   node beside the synthetic hosts ``RES_FLEET``, the whole operator
   running through ``running_operator``. The write-verb matrix
   (``WRITE_VERB_FAULTS``: 429, 500, 503 and latency on POST, PUT, APPLY
   and LIST) brings the CR to READY with every fault consumed, the card's
   node labelled and advertising every card, and a faulted DELETE
   converges; a 1 s partition trips the breaker, which closes, and a spec
   edit after it lands; a state whose control raises leaves the other
   states' DaemonSets in place under Degraded, lifted once the fault
   clears (``run_fault_matrix``). Every card unhealthy through its servicer
   quarantines the card's node (cordon, taint, label) after its ``gpu-*``
   operand pods restart, no other node touched, and the cards back recover
   it; a synthetic host flaps to ``exhausted``; the card and one host dead
   before remediation turns on open the breaker with 0 disruptions, and
   the host back closes it; a crash-looping operand pod on the card's node
   restarts without quarantine (``run_remediation_matrix``). Four kubelet
   rigs over gRPC, the card's and three ``SyntheticChipServicer`` boards,
   form ``RES_SLICE``, which goes ready, not ready with a ``SliceDegraded``
   Event naming the card's node when its cards go Unhealthy, and ready
   again (``run_slice_loop``). A storm seeded with ``CHAOS_SEED`` over a
   fleet holding the card's node, the operator restarted halfway, settles
   READY with every slice verdict equal to its recomputation
   (``run_chaos``). Every alert's metric is exported, and ``NodeMetrics``
   on the card's node reads the card count (``check_alert_names``). The
   times are logged beside the card's name and power limit; this path
   launches none of K1-K7c;
4. run the validator CLI for the same three components and the five
   multi-device ones as subprocesses, each writing its status file into a
   temporary directory.

Then it prints one ``kernels`` JSON line, each kernel's launches read from
the path that runs it (K1-K3 phase 3, K4-K6b phase 3b, K7a-c phase 3c).

The last line of standard output is one JSON object naming the device.
Without a CUDA device, or without the ``tpu_operator_torch`` package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import faulthandler
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import urllib.request

import torch

COPY_REPLACES = "tpu_operator/workloads/membw.py"
FLASH_FILE = "tpu_operator/workloads/flashattn.py"
FLASH_REPLACES = f"{FLASH_FILE}:112"
FLASH_TOL_PLAIN = 1e-2  # same function, f32 sums in another order, p rounded per sub-tile
FLASH_TOL_ORACLE = 2e-2  # the reference's oracle tolerance
# (heads, seq, block_q, block_k, causal) where the blocks do not divide seq:
# a partial last q-block whose second warpgroup lies wholly past seq, and a
# k-block cut at seq (520 at 128/128); a single partial q-block and k-block
# (72 at 64/64; 100 at 64/64, a seq the reference tiles 100/100); no mask
# but the last k-block's bound (200 at 64/128)
PARTIAL_TILE_SHAPES = [
    (2, 520, 128, 128, True),
    (1, 72, 64, 64, True),
    (2, 200, 64, 128, False),
    (1, 100, 64, 64, True),
]
# seconds the partial-tile checks may take before the watchdog ends the run
PARTIAL_TILE_TIMEOUT_S = 120

# (heads, seq, block_q, block_k, causal): the CPU tests' shapes
FLASH_TEST_SHAPES = [
    (2, 256, 128, 128, True),
    (2, 256, 128, 128, False),
    (1, 512, 128, 256, True),
]
# K3's Hopper kernel at its edges: one warpgroup and a q-block with a
# single sub-tile (64/64), one warpgroup (64/128), eight sub-tiles per
# k-block so the ring wraps inside a block (128/512), and no mask
K3_EDGE_SHAPES = [
    (1, 128, 64, 64, True),
    (2, 256, 64, 128, True),
    (2, 1024, 128, 512, True),
    (2, 1024, 128, 128, False),
]
WGMMA_KERNEL = "flash_fwd_wgmma_kernel"  # the Hopper kernel's __global__ in csrc/flash.cu
# its instances by (Step, Body) as the mangled name spells them:
# flash_fwd_wgmma_kernel<Step, Body, int STAGES> gives ...LNS_4StepE<s>ELNS_4BodyE<b>E...,
# Step::kFull = 0, kBf16Exp = 1, kStub = 2, kQkOnly = 3, kBf16S = 4; Body::kOne = 0,
# kPair = 1, kPipe = 2
WGMMA_INSTANCES = {
    ("0", "0"): "K3", ("0", "1"): "K7a", ("0", "2"): "K4", ("1", "0"): "K5", ("2", "0"): "K6a",
    ("3", "0"): "K6b", ("4", "0"): "K7b", ("4", "1"): "K7c",
}
# the stubs, whose SASS must hold no exp: their softmax is gone
NO_SOFTMAX = ("K6a", "K6b")
WGMMA_NAME_ARGS = re.compile(r"StepE(\d+)E.*?BodyE(\d+)E")
# the softmax's instruction mix, logged per instance (static counts in its
# SASS, every copy of the loop body): exp, f32->bf16x2 packs, f32 and
# packed bf16 max, packed bf16 fma
SOFTMAX_OPS = ("MUFU.EX2", "F2FP", "FMNMX", "HMNMX2", "HFMA2")
# host microseconds a call of the Hopper kernel may spend beyond a launch
# that encodes no tensor map (K1 on a small buffer), its tensor maps: 5% of
# K3's ~0.39 ms at the main path's shape, where the host would start to set
# the pace of a chain of launches
K3_HOST_LIMIT_US = 20.0
# the variants' shapes: the reference's seq-1024 test at the port's blocks
VARIANT_TEST_SHAPES = FLASH_TEST_SHAPES + [
    (2, 1024, 128, 128, True),
    (2, 1024, 128, 256, True),
]
# (variant, kernel, line of the TPU kernel it replaces), on the attribution path
VARIANTS = [
    ("pipelined", "flash_fwd_pipelined", 209),
    ("bf16exp", "flash_fwd_bf16exp", 153),
    ("softmax_stub", "flash_softmax_stub", 192),
    ("qk_only", "flash_qk_only", 181),
]
ATTRIBUTION_KERNELS = ["flash_fwd"] + [name for _, name, _ in VARIANTS]
EXPERIMENT_FILE = "scripts/fa_experiment.py"
# (mode, kernel, line of the mode's branch of build(), the TPU kernel it
# replaces), on the structural-variant path
MODES = [
    ("paired", "flash_fwd_paired", 90),
    ("bf16s", "flash_fwd_bf16s", 109),
    ("paired16", "flash_fwd_paired16", 69),
]
# 1 x 512 at 64/64: q-block i has i unmasked sub-tiles, so the odd counts
# 3, 5 and 7 leave K7a and K7c one to run alone and K4 its loop's second
# exit (the drain's S carried in from the last pipelined step)
ODD_UNMASKED_SHAPE = (1, 512, 64, 64, True)
# the variants' causal shapes, the odd-count shape, and the causal edges
# of the Hopper kernel, among them 128/512, where the ring wraps inside a
# k-block
STRUCTURAL_TEST_SHAPES = [s for s in VARIANT_TEST_SHAPES if s[4]] + [
    ODD_UNMASKED_SHAPE,
] + [s for s in K3_EDGE_SHAPES if s[4]]
# where the attribution variants K4-K6b also run (K6b where block_k >= 128)
HOPPER_VARIANT_SHAPES = K3_EDGE_SHAPES + [ODD_UNMASKED_SHAPE]
# (seq, the card's default blocks there) of the probes counted apart from
# the main path: 4160, which the reference's block rule tiles 104/104 and
# no kernel takes; 8200 (8192 + 8), which 128 does not divide
PROBE_EDGES = [(4160, (64, 64)), (8200, (128, 128))]
BF16_ULP = 2.0**-7  # bf16 keeps 8 significant bits: one ulp is at most 2^-7 of |x|
# the matmul step against the host's product: a sum in another order lands
# on the other side of a bf16 rounding boundary at a few elements; rounding
# the sum before the scale as well moves most of them (70% on the CPU)
# phase 7: the device plugin's watchdog, and what a container with
# Allocate's env sees (a product on each card, then the cards' UUIDs)
PLUGIN_TIMEOUT_S = 120
OPERANDS_NODE = "chip-smoke-node"  # the card's node in phases 7, 8 and 10
CONTAINER_VIEW_SCRIPT = (
    "import json, torch; n = torch.cuda.device_count(); "
    "[torch.mm(torch.ones(64, 64, device=i), torch.ones(64, 64, device=i)).sum().item() "
    "for i in range(n)]; "
    "print(json.dumps([n, ['GPU-' + str(torch.cuda.get_device_properties(i).uuid) for i in range(n)]]))"
)
MATMUL_CHECK_SIZE = 1000
MATMUL_MISS_SHARE = 0.01
CLI_CHAIN = [
    ("cuda", ["--matmul-size", "8192"], "cuda-ready"),
    ("membw", ["--membw-size-mb", "2048"], "membw-ready"),
    ("flashattn", ["--flashattn-seq", "8192", "--flashattn-heads", "8"], "flashattn-ready"),
]
# the multi-device components at their defaults: every card, full widths
MULTIDEVICE_CLI = [
    ("slice", [], "slice-ready"),
    ("ici", [], "ici-ready"),
    ("ringattn", [], "ringattn-ready"),
    ("pipeline", [], "pipeline-ready"),
    ("moe", [], "moe-ready"),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls,
    from CUDA events."""
    from tpu_operator_torch.workloads.timing import event_ms

    return event_ms(fn, reps, warmup)


def phase_setup():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(f"card: {smi.stdout.strip() or smi.stderr.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    from tpu_operator_torch import _build

    nvcc = subprocess.run(
        [_build.find_nvcc(), "--version"], capture_output=True, text=True, timeout=60
    )
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    _build.library()
    info = _build.build_info
    log(f"kernels built={info['built']} in {info['seconds']:.1f} s: {info['path']}")
    # the native programs, so that every later phase reads the chip table
    # through libgpuinfo
    from tpu_operator_torch.native import build as native_build

    native = native_build.build()
    log(f"native programs ({native_build.cxx_version()}) built={native['built']} in "
        f"{native['seconds']:.2f} s: {native['dir']}")
    ptxas = os.path.join(os.path.dirname(info["path"]), "ptxas.log")
    serialized = []
    if os.path.exists(ptxas):
        with open(ptxas) as f:
            for line in f:
                if any(w in line for w in ("registers", "spill", "Compiling", "wgmma", "C75")):
                    log("  ptxas " + line.strip())
                # C7515 serializes a wgmma chain; C7519 injects a
                # warpgroup.arrive where a register in use by one is touched
                if "(C7515)" in line or "(C7519)" in line or (
                        "wgmma" in line and "serializ" in line):
                    serialized.append(line.strip())
    if serialized:
        raise RuntimeError(f"ptxas serialized wgmma: {serialized}")
    wgmma_sass()


def peaks():
    from tpu_operator_torch.workloads.matmul import device_generation
    from tpu_operator_torch.workloads.topology import PEAK_BF16_TFLOPS, PEAK_HBM_GBPS

    gen = device_generation(torch.cuda.get_device_name(0))
    if gen is None:
        log("unknown card: bounds use the H100 SXM datasheet rates")
        gen = "h100-sxm"
    return PEAK_BF16_TFLOPS[gen] * 1e12, PEAK_HBM_GBPS[gen] * 1e9


def check_partial_tiles(fa, qkv) -> dict:
    """Every flash kernel at PARTIAL_TILE_SHAPES against its plain version
    (check_variant, check_modes), under a watchdog that ends the run with
    a traceback after PARTIAL_TILE_TIMEOUT_S; returns each kernel's worst
    |kernel - plain| by launch counter."""
    from tpu_operator_torch.workloads import fa_experiment as fx

    worst = {}
    faulthandler.dump_traceback_later(PARTIAL_TILE_TIMEOUT_S, exit=True)
    try:
        for h, s, bq, bk, causal in PARTIAL_TILE_SHAPES:
            q, k, v = qkv(h, s)
            variants = ["full", "pipelined", "bf16exp", "softmax_stub"]
            if bk >= fa.LANES:
                variants.append("qk_only")
            errs = {fa.VARIANT_KERNELS[variant][0]: check_variant(fa, variant, q, k, v, bq, bk,
                                                                  causal)
                    for variant in variants}
            if causal:
                errs.update((fx.MODE_KERNELS[mode], err)
                            for mode, err in check_modes(fa, fx, q, k, v, bq, bk).items())
            for name, err in errs.items():
                worst[name] = max(worst.get(name, 0.0), err)
        torch.cuda.synchronize()
    finally:
        faulthandler.cancel_dump_traceback_later()
    log(f"partial tiles: every flash kernel within its tolerance at {PARTIAL_TILE_SHAPES}")
    return worst


def phase_kernels() -> tuple:
    from tpu_operator_torch.workloads import flashattn as fa
    from tpu_operator_torch.workloads import membw as mb

    dev = torch.device("cuda")
    peak_flops, peak_bytes = peaks()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = mb.probe_rows(2048)
    kernels = []

    # K1 and K2: bit-exact at a small shape and at the probe's 2 GiB
    small = torch.arange(8 * mb.LANES, device=dev, dtype=torch.float32).reshape(8, mb.LANES)
    big = torch.randn((rows, mb.LANES), generator=gen, device=dev, dtype=torch.float32)
    dst = torch.empty_like(big)

    def bit_exact(name, wrapper) -> float:
        err = 0.0
        for x in (small, big):
            got, plain = wrapper(x), mb.plain_copy(x)
            torch.cuda.synchronize()
            if not torch.equal(got, plain):
                raise RuntimeError(f"{name} is not bit-exact at {tuple(x.shape)}")
            err = max(err, float((got - plain).abs().max()))
            del got, plain
        return err

    for name, wrapper, line in (
        ("tiled_copy", mb.tiled_copy, 86),
        ("bulk_copy", mb.bulk_copy, 116),
    ):
        err = bit_exact(name, wrapper)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tpu_operator_torch/csrc/copy.cu",
            "replaces": f"{COPY_REPLACES}:{line}",
            "shape": list(big.shape),
            "max_abs_err": err,
            "ms": time_ms(lambda: wrapper(big), 20),
            "plain_ms": time_ms(lambda: mb.plain_copy(big), 20),
            "bound_ms": 2.0 * big.numel() * 4 / peak_bytes * 1e3,
            "bound_by": "bytes",
            "library_ms": time_ms(lambda: dst.copy_(big), 20),
        })
        log(f"{name}: bit-exact at (8, {mb.LANES}) and {tuple(big.shape)}")
    # K1's tried Hopper design (TMA ring, persistent grid), on no path:
    # checked as K1 is and timed beside it in this run
    bit_exact("tiled_copy_tma", mb.tiled_copy_tma)
    k1 = kernels[0]
    log(f"K1's tried Hopper design (tiled_copy_tma): bit-exact, "
        f"{time_ms(lambda: mb.tiled_copy_tma(big), 20):.4f} ms against K1 {k1['ms']:.4f}, "
        f"Tensor.copy_ {k1['library_ms']:.4f}, bound {k1['bound_ms']:.4f}")
    del big, small, dst
    torch.cuda.empty_cache()

    def qkv(heads, seq):
        return [
            torch.randn((heads, seq, fa.LANES), generator=gen, device=dev,
                        dtype=torch.bfloat16)
            for _ in range(3)
        ]

    partial = check_partial_tiles(fa, qkv)
    torch.cuda.empty_cache()
    # K3: the CPU tests' shapes, then the probe's shape
    heads, seq = 8, 8192
    bq, bk = fa.card_blocks(seq)
    worst = 0.0
    for h, s, bq_, bk_, causal in FLASH_TEST_SHAPES + K3_EDGE_SHAPES + [(heads, seq, bq, bk, True)]:
        q, k, v = qkv(h, s)
        got = fa.flash_attention(q, k, v, bq_, bk_, causal).float()
        plain = fa.plain_flash(q, k, v, bq_, bk_, causal).float()
        ref = fa.reference_attention(q, k, v, causal)
        err_plain = float((got - plain).abs().max())
        err_ref = float((got - ref).abs().max())
        plain_ref = float((plain - ref).abs().max())
        log(f"flash_fwd H={h} S={s} {bq_}/{bk_} causal={causal}: "
            f"|kernel-plain|={err_plain:.3e} |kernel-oracle|={err_ref:.3e} "
            f"|plain-oracle|={plain_ref:.3e}")
        if not torch.isfinite(got).all():
            raise RuntimeError("flash_fwd produced non-finite values")
        if not (err_plain <= FLASH_TOL_PLAIN and err_ref < FLASH_TOL_ORACLE):
            raise RuntimeError(f"flash_fwd disagrees at H={h} S={s} causal={causal}")
        worst = max(worst, err_plain)
        del got, plain, ref
    torch.cuda.empty_cache()
    wgmma_refuse_block_q_32(fa, q, k, v)
    wgmma_host_cost(fa, mb, qkv)
    useful = 4.0 * heads * fa.LANES * seq * (seq + 1) / 2.0
    io_bytes = 4.0 * heads * seq * fa.LANES * 2
    bound_flops, bound_io = useful / peak_flops, io_bytes / peak_bytes
    kernels.append({
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tpu_operator_torch/csrc/flash.cu",
        "replaces": FLASH_REPLACES,
        "shape": [heads, seq, fa.LANES, bq, bk],
        "max_abs_err": worst,
        "ms": time_ms(lambda: fa.flash_attention(q, k, v, bq, bk, True), 20),
        "plain_ms": time_ms(lambda: fa.plain_flash(q, k, v, bq, bk, True), 2, warmup=1),
        "bound_ms": max(bound_flops, bound_io) * 1e3,
        "bound_by": "operations" if bound_flops >= bound_io else "bytes",
        # (1, H, S, D): a batch dimension lets PyTorch pick its fused kernel
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True), 20),
    })
    del q, k, v
    torch.cuda.empty_cache()
    kernels += variant_rows(fa, qkv, peak_flops, peak_bytes)
    for row in kernels:
        row["max_abs_err"] = max(row["max_abs_err"], partial.get(row["name"], 0.0))
    return kernels, partial


def wgmma_callers(fa):
    """(label, launch counter, fn(q, k, v, block_q, block_k)) of the eight
    kernels that run on the Hopper kernel, through their wrappers."""
    from tpu_operator_torch.workloads import fa_experiment as fx

    def variant(name):
        return lambda q, k, v, bq, bk: fa.flash_attention(q, k, v, bq, bk, True, name)

    def mode(name):
        return lambda q, k, v, bq, bk: fx.experiment_flash(q, k, v, bq, bk, name)

    return [
        ("K3", "flash_fwd", variant("full")),
        ("K4", "flash_fwd_pipelined", variant("pipelined")),
        ("K5", "flash_fwd_bf16exp", variant("bf16exp")),
        ("K6a", "flash_softmax_stub", variant("softmax_stub")),
        ("K6b", "flash_qk_only", variant("qk_only")),
        ("K7a", "flash_fwd_paired", mode("paired")),
        ("K7b", "flash_fwd_bf16s", mode("bf16s")),
        ("K7c", "flash_fwd_paired16", mode("paired16")),
    ]


def wgmma_refuse_block_q_32(fa, q, k, v) -> None:
    """The Hopper kernel runs whole warpgroups: each of its eight instances
    must raise ValueError at block_q 32 on the card before any launch."""
    from tpu_operator_torch import _build

    for label, name, run in wgmma_callers(fa):
        before = _build.launches[name]
        try:
            run(q, k, v, 32, 128)
        except ValueError as e:
            log(f"{label} at 32/128 refused: {e}")
        else:
            raise RuntimeError(f"{label} took block_q 32")
        if _build.launches[name] != before:
            raise RuntimeError(f"{label} launched at block_q 32")


def wgmma_host_cost(fa, mb, qkv) -> None:
    """Host microseconds a call of each Hopper instance (each encodes two
    or three tensor maps per call) and of K1 on an (8, LANES) f32 buffer (a
    launch through the same kind of wrapper that encodes no map) take at
    shapes whose kernels are shorter than their enqueue, so the host sets
    the pace; the least of three readings each. Fails when the maps cost
    more than K3_HOST_LIMIT_US a call: then they must be cached."""
    q, k, v = qkv(1, 128)
    buf = torch.zeros((8, mb.LANES), device=q.device, dtype=torch.float32)

    def host_us(run):
        for _ in range(10):
            run(q, k, v, 64, 128)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            run(q, k, v, 64, 128)
        us = (time.perf_counter() - t0) / 100 * 1e6
        torch.cuda.synchronize()
        return us

    base = min(host_us(lambda *_: mb.tiled_copy(buf)) for _ in range(3))
    costs = {label: min(host_us(run) for _ in range(3)) for label, _, run in wgmma_callers(fa)}
    log(f"host us per call: K1 at (8, {mb.LANES}) {base:.2f}; at 1 x 128, 64/128: "
        + ", ".join(f"{label} {us:.2f}" for label, us in costs.items()))
    for label, us in costs.items():
        if us - base > K3_HOST_LIMIT_US:
            raise RuntimeError(f"{label}'s tensor maps cost {us - base:.1f} us a call, "
                               f"above {K3_HOST_LIMIT_US} us")


def wgmma_sass() -> None:
    """Count HGMMA (wgmma), UTMALDG (TMA loads) and HMMA (the warp-level
    MMA) in each instance of the Hopper kernel in the built library's SASS;
    fail unless the eight of WGMMA_INSTANCES are all there, each with HGMMA
    and UTMALDG, K6a and K6b with no MUFU.EX2 (no softmax), and no function
    of the library has HMMA. The softmax's instruction mix (SOFTMAX_OPS) is
    logged."""
    from tpu_operator_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", _build.build_info["path"]], capture_output=True, text=True,
        timeout=120,
    ).stdout
    found, hmma = {}, []
    for body in sass.split("Function : ")[1:]:
        name = body.split("\n", 1)[0]
        if " HMMA" in body:
            hmma.append(name.strip())
        if WGMMA_KERNEL not in name:
            continue
        args = WGMMA_NAME_ARGS.search(name)
        label = WGMMA_INSTANCES.get(args.groups() if args else None, name.strip())
        found[label] = (body.count("HGMMA"), body.count("UTMALDG"), body.count("MUFU.EX2"))
        log(f"{WGMMA_KERNEL} {label} SASS: HGMMA {found[label][0]}, "
            f"UTMALDG {found[label][1]}, HMMA {body.count(' HMMA')}; "
            + ", ".join(f"{op} {body.count(op)}" for op in SOFTMAX_OPS))
    if sorted(found) != sorted(WGMMA_INSTANCES.values()):
        raise RuntimeError(f"{WGMMA_KERNEL} instances in the SASS: {sorted(found)}, "
                           f"expected {sorted(WGMMA_INSTANCES.values())}")
    if hmma:
        raise RuntimeError(f"HMMA in the library's SASS: {hmma}")
    for label, (hgmma, utmaldg, ex2) in found.items():
        if hgmma == 0 or utmaldg == 0 or (label in NO_SOFTMAX and ex2):
            raise RuntimeError(f"{label} has HGMMA {hgmma}, UTMALDG {utmaldg}, MUFU.EX2 {ex2}")


def check_variant(fa, variant, q, k, v, bq, bk, causal) -> float:
    """One variant's kernel against its plain version (and, for the three
    that compute attention, the f32 oracle; K4 must equal K3 bit for bit);
    raises on a miss."""
    got = fa.flash_attention(q, k, v, bq, bk, causal, variant)
    if not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{variant} produced non-finite values")
    plain = fa.plain_variant(q, k, v, bq, bk, causal, variant).float()
    diff = (got.float() - plain).abs()
    err = float(diff.max())
    where = f"{variant} H={q.shape[0]} S={q.shape[1]} {bq}/{bk} causal={causal}"
    if variant in ("full", "pipelined", "bf16exp"):
        err_ref = float((got.float() - fa.reference_attention(q, k, v, causal)).abs().max())
        note = f"|kernel-oracle|={err_ref:.3e}"
        ok = err <= FLASH_TOL_PLAIN and err_ref < FLASH_TOL_ORACLE
        if variant == "pipelined":
            full = fa.flash_attention(q, k, v, bq, bk, causal)
            same = torch.equal(got, full)
            err_k3 = float((got.float() - full.float()).abs().max())
            note += f" bit-exact-vs-K3={same} |kernel-K3|={err_k3:.3e}"
            ok = ok and same
    elif variant == "qk_only":
        ok = bool((diff <= BF16_ULP * plain.abs() + 1e-3).all())
        note = "within one bf16 ulp" if ok else "beyond one bf16 ulp"
    else:
        ok = err <= FLASH_TOL_PLAIN
        note = ""
    log(f"{where}: |kernel-plain|={err:.3e} {note}")
    if not ok:
        raise RuntimeError(f"{where} disagrees with its reference")
    return err


def variant_rows(fa, qkv, peak_flops, peak_bytes) -> list:
    """K4-K6b: checked at the variants' test shapes, at
    ``HOPPER_VARIANT_SHAPES`` (K6b where ``block_k`` >= 128) and at the
    breakdown's (8, 8192, 128/128, causal), then timed at the breakdown's
    shape."""
    heads, seq = 8, 8192
    bq, bk = fa.BLOCK_Q_CAP, fa.BLOCK_K_CAP
    worst = {variant: 0.0 for variant, _, _ in VARIANTS}
    shapes = [(shape, tuple(worst)) for shape in VARIANT_TEST_SHAPES]
    shapes += [(shape, tuple(v for v in worst if v != "qk_only" or shape[3] >= fa.LANES))
               for shape in HOPPER_VARIANT_SHAPES]
    shapes.append(((heads, seq, bq, bk, True), tuple(worst)))
    for (h, s, bq_, bk_, causal), variants in shapes:
        q, k, v = qkv(h, s)
        for variant in variants:
            err = check_variant(fa, variant, q, k, v, bq_, bk_, causal)
            worst[variant] = max(worst[variant], err)
        torch.cuda.empty_cache()
    performed = fa.causal_flops(seq, heads, fa.LANES, bq, bk)
    useful = 4.0 * heads * fa.LANES * seq * (seq + 1) / 2.0
    tensor_bytes = heads * seq * fa.LANES * 2
    rows = []
    for variant, name, line in VARIANTS:
        # operations and bytes each variant must do: the two attention
        # variants the useful triangle; the instruments what they perform
        flops = {"softmax_stub": performed, "qk_only": performed / 2}.get(variant, useful)
        io_bytes = (3 if variant == "qk_only" else 4) * tensor_bytes
        bound_flops, bound_io = flops / peak_flops, io_bytes / peak_bytes
        library_ms = None
        if variant in ("pipelined", "bf16exp"):
            # (1, H, S, D): a batch dimension lets PyTorch pick its fused kernel
            library_ms = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=True), 20)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "tpu_operator_torch/csrc/flash.cu",
            "replaces": f"{FLASH_FILE}:{line}",
            "shape": [heads, seq, fa.LANES, bq, bk],
            "max_abs_err": worst[variant],
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, bq, bk, True, variant), 20),
            "plain_ms": time_ms(
                lambda: fa.plain_variant(q, k, v, bq, bk, True, variant), 2, warmup=1),
            "bound_ms": max(bound_flops, bound_io) * 1e3,
            "bound_by": "operations" if bound_flops >= bound_io else "bytes",
            "library_ms": library_ms,
        })
    del q, k, v
    torch.cuda.empty_cache()
    return rows


def check_matmul_rounding() -> None:
    """One step of the chain on the card against the host's f32 product,
    scaled by ``1/size`` and then rounded to bf16 once, as the reference
    does."""
    from tpu_operator_torch.workloads.matmul import make_matmul_step

    size = MATMUL_CHECK_SIZE
    fn, (a, b) = make_matmul_step(size=size, depth=1)
    got = fn(a, b).cpu().float()
    a32, b32 = a.cpu().float(), b.cpu().float()
    want = ((a32 @ b32) * (1.0 / size)).to(torch.bfloat16).float()
    off = got != want
    share = float(off.float().mean())
    # one bf16 ulp, plus what summing in another order may move an f32 sum
    # (size * 2^-24 * sum |a b|) where cancellation leaves a tiny value
    order = size * 2.0**-24 * (a32.abs() @ b32.abs()) * (1.0 / size)
    bound = BF16_ULP * torch.maximum(got.abs(), want.abs()) + order
    beyond = int(((got - want).abs() > bound).sum())
    log(f"matmul step at {size}: {int(off.sum())} of {got.numel()} elements off the host's "
        f"once-rounded product ({share:.2e}), {beyond} beyond one bf16 ulp")
    if beyond or share > MATMUL_MISS_SHARE:
        raise RuntimeError(f"the matmul step does not round once like the reference at {size}")


def phase_main_path() -> dict:
    from tpu_operator_torch import _build
    from tpu_operator_torch.entry import entry
    from tpu_operator_torch.workloads.flashattn import run_flashattn_probe
    from tpu_operator_torch.workloads.matmul import run_matmul_validation
    from tpu_operator_torch.workloads.membw import run_membw_probe

    _build.reset_launches()
    fn, (a, b) = entry()
    out = fn(a, b)
    if out.shape != (1024, 1024) or not torch.isfinite(out.float()).all():
        raise RuntimeError("entry() chain gave a wrong shape or non-finite values")
    check_matmul_rounding()
    mm = run_matmul_validation(size=8192)
    bw = run_membw_probe(size_mb=2048)
    fl = run_flashattn_probe(seq=8192, heads=8)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    # the card's default blocks at the edge seqs, each counted apart from
    # the main path
    edges = []
    for seq, blocks in PROBE_EDGES:
        _build.reset_launches()
        edge = run_flashattn_probe(seq=seq, heads=8)
        torch.cuda.synchronize()
        edge_launches = _build.launches["flash_fwd"]
        log(f"flash probe at seq {seq}: blocks {edge.block_q}/{edge.block_k}, "
            f"{edge_launches} flash_fwd launches")
        if edge.ok and (edge.block_q, edge.block_k) != blocks:
            raise RuntimeError(f"the probe at seq {seq} ran {edge.block_q}/{edge.block_k}, "
                               f"expected {blocks}")
        if edge.ok and edge_launches <= 0:
            raise RuntimeError(f"the probe at seq {seq} never launched flash_fwd")
        edges.append((f"flashattn seq {seq}", edge))
    for name, res in [("matmul", mm), ("membw", bw), ("flashattn", fl), *edges]:
        log(f"{name}: {json.dumps(res.to_dict())}")
        if not res.ok:
            raise RuntimeError(f"{name} failed: {res.error}")
    if not bw.integrity:
        raise RuntimeError("membw copy integrity failed")
    log(f"launches on the main path: {launches}")
    for name in ("bulk_copy", "flash_fwd"):
        if launches[name] <= 0:
            raise RuntimeError(f"the main path never launched {name}")
    return launches


def phase_attribution() -> dict:
    from tpu_operator_torch import _build
    from tpu_operator_torch.workloads.fa_variant_check import run_variant_check
    from tpu_operator_torch.workloads.flashattn import (
        run_flashattn_breakdown,
        run_flashattn_probe,
    )

    _build.reset_launches()
    breakdown = run_flashattn_breakdown(seq=8192, heads=8, iters=16)
    # at full width: the plain K5 passes the oracle at 8 x 8192 on the CPU too
    probe = run_flashattn_probe(seq=8192, heads=8, variant="bf16exp")
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    # K3 against K4, counted apart from the attribution path
    _build.reset_launches()
    check = run_variant_check()
    torch.cuda.synchronize()
    check_launches = {name: _build.launches[name] for name in ("flash_fwd", "flash_fwd_pipelined")}
    log(f"breakdown: {json.dumps(breakdown)}")
    log(f"bf16exp probe: {json.dumps(probe.to_dict())}")
    log(f"fa_variant_check: {json.dumps(check)}")
    ratio = check["wall_speedup"]["pipelined"]
    log(f"K3/K4 wall-time ratio (full/pipelined, >1 = K4 faster): median "
        f"{ratio['median']}, IQR {ratio['iqr']}")
    if not breakdown["ok"]:
        raise RuntimeError(f"breakdown failed: {breakdown.get('error')}")
    if not probe.ok:
        raise RuntimeError(f"bf16exp probe failed: {probe.error}")
    for name, err in check["max_err"].items():
        if not err < FLASH_TOL_ORACLE:
            raise RuntimeError(f"fa_variant_check: {name} diverged from the oracle: {err}")
    log(f"launches on the attribution path: {launches}")
    for name in ATTRIBUTION_KERNELS:
        if launches[name] <= 0:
            raise RuntimeError(f"the attribution path never launched {name}")
    log(f"launches in fa_variant_check: {check_launches}")
    for name, n in check_launches.items():
        if n <= 0:
            raise RuntimeError(f"fa_variant_check never launched {name}")
    return launches


def check_modes(fa, fx, q, k, v, bq, bk) -> dict:
    """K7a-c against their plain versions and the f32 oracle, K7a equal to
    K3 and K7c equal to K7b bit for bit, at one causal shape; raises on a
    miss and returns each mode's |kernel - plain|.

    The two softmaxes (f32 for K7a, half width for K7b/K7c) differ by less
    than the plain tolerance, so each kernel must also sit nearer, in
    mean-abs, to its own softmax's plain version than to the other's, and
    K7b/K7c must not equal K3: a kernel running the wrong softmax fails."""
    ref = fa.reference_attention(q, k, v)
    plain = {mode: fx.plain_mode(q, k, v, bq, bk, mode).float() for mode, _, _ in MODES}
    other = {"paired": plain["bf16s"], "bf16s": plain["paired"], "paired16": plain["paired"]}
    k3 = fa.flash_attention(q, k, v, bq, bk, True)
    where = f"H={q.shape[0]} S={q.shape[1]} {bq}/{bk} causal"
    outs, errs, ok = {}, {}, True
    for mode, _, _ in MODES:
        got = outs[mode] = fx.experiment_flash(q, k, v, bq, bk, mode)
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"{mode} produced non-finite values at {where}")
        diff = (got.float() - plain[mode]).abs()
        errs[mode] = float(diff.max())
        err_ref = float((got.float() - ref).abs().max())
        mean_own = float(diff.mean())
        mean_other = float((got.float() - other[mode]).abs().mean())
        log(f"{mode} {where}: |kernel-plain|={errs[mode]:.3e} |kernel-oracle|={err_ref:.3e} "
            f"mean|kernel-plain|={mean_own:.3e} mean|kernel-other softmax's plain|="
            f"{mean_other:.3e}")
        ok = (ok and errs[mode] <= FLASH_TOL_PLAIN and err_ref < FLASH_TOL_ORACLE
              and mean_own < mean_other)
        if mode != "paired" and torch.equal(got, k3):
            log(f"{mode} {where}: equals K3, so it did not run the half-width softmax")
            ok = False
    for paired, single, base in (("paired", "K3", k3), ("paired16", "K7b", outs["bf16s"])):
        err = float((outs[paired].float() - base.float()).abs().max())
        same = torch.equal(outs[paired], base)
        log(f"{paired} {where}: bit-exact-vs-{single}={same} |kernel-{single}|={err:.3e}")
        ok = ok and err <= FLASH_TOL_PLAIN and same
    if not ok:
        raise RuntimeError(f"a structural variant disagrees with its reference at {where}")
    return errs


def phase_structural(partial: dict) -> list:
    """K7a-c: checked, driven through ``run_experiment`` with the launch
    counts read just after, then timed; ``partial`` is
    ``check_partial_tiles``'s worst errors, which their rows take in."""
    from tpu_operator_torch import _build
    from tpu_operator_torch.workloads import fa_experiment as fx
    from tpu_operator_torch.workloads import flashattn as fa

    dev = torch.device("cuda")
    peak_flops, peak_bytes = peaks()
    gen = torch.Generator(device=dev).manual_seed(0)
    heads, seq = 8, 8192
    bq, bk = fa.BLOCK_Q_CAP, fa.BLOCK_K_CAP

    def qkv(h, s):
        return [torch.randn((h, s, fa.LANES), generator=gen, device=dev, dtype=torch.bfloat16)
                for _ in range(3)]

    worst = {mode: 0.0 for mode, _, _ in MODES}
    for h, s, bq_, bk_, _ in STRUCTURAL_TEST_SHAPES + [(heads, seq, bq, bk, True)]:
        for mode, err in check_modes(fa, fx, *qkv(h, s), bq_, bk_).items():
            worst[mode] = max(worst[mode], err)
        torch.cuda.empty_cache()

    _build.reset_launches()
    experiment = fx.run_experiment(fx.MODES, seq=seq, heads=heads, reps=7)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    log(f"fa_experiment: {json.dumps(experiment)}")
    log(f"launches on the structural-variant path: {launches}")
    for name, err in experiment["max_err"].items():
        if not err < FLASH_TOL_ORACLE:
            raise RuntimeError(f"{name} diverged from the oracle on the path: {err}")
    for _, name, _ in MODES:
        if launches[name] <= 0:
            raise RuntimeError(f"the structural-variant path never launched {name}")

    q, k, v = qkv(heads, seq)
    useful = 4.0 * heads * fa.LANES * seq * (seq + 1) / 2.0
    bound_flops, bound_io = useful / peak_flops, 4.0 * heads * seq * fa.LANES * 2 / peak_bytes
    # (1, H, S, D): a batch dimension lets PyTorch pick its fused kernel
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True), 20)
    rows = []
    for mode, name, line in MODES:
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "tpu_operator_torch/csrc/flash.cu",
            "replaces": f"{EXPERIMENT_FILE}:{line}",
            "shape": [heads, seq, fa.LANES, bq, bk],
            "launches": launches[name],
            "max_abs_err": max(worst[mode], partial.get(name, 0.0)),
            "ms": time_ms(lambda: fx.experiment_flash(q, k, v, bq, bk, mode), 20),
            "plain_ms": time_ms(lambda: fx.plain_mode(q, k, v, bq, bk, mode), 2, warmup=1),
            "bound_ms": max(bound_flops, bound_io) * 1e3,
            "bound_by": "operations" if bound_flops >= bound_io else "bytes",
            "library_ms": library_ms,
        })
    del q, k, v
    torch.cuda.empty_cache()
    return rows


def burnin_step_seconds(world, steps: int) -> float:
    """Seconds a burn-in train step takes at the validator's widths, the
    slowest rank's, after one warm-up step (a rank function)."""
    import torch.distributed as dist

    from tpu_operator_torch.workloads.burnin import build_burnin
    from tpu_operator_torch.workloads.mesh import all_reduce_scalar

    _, train_step, params, (x, y) = build_burnin(world)
    params, _ = train_step(params, x, y)
    world.sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, loss = train_step(params, x, y)
    world.sync()
    return all_reduce_scalar((time.perf_counter() - t0) / steps, dist.ReduceOp.MAX, world.device)


def phase_multidevice() -> None:
    """The five probes and the dryrun on every card over NCCL; fails unless
    each is ok."""
    from tpu_operator_torch.entry import dryrun_multichip
    from tpu_operator_torch.workloads.burnin import run_burnin
    from tpu_operator_torch.workloads.mesh import spawn_world
    from tpu_operator_torch.workloads.moe import run_moe
    from tpu_operator_torch.workloads.pipeline import run_pipeline
    from tpu_operator_torch.workloads.ring import run_ring_probe
    from tpu_operator_torch.workloads.ringattn import run_ringattn

    n = torch.cuda.device_count()
    probes = [
        ("burnin", lambda: run_burnin(n, steps=10)),
        ("ring", lambda: run_ring_probe(n)),
        ("ringattn", lambda: run_ringattn(n)),
        ("pipeline", lambda: run_pipeline(n)),
        ("moe", lambda: run_moe(n)),
    ]
    results, failed = {}, []
    for name, run in probes:
        t0 = time.perf_counter()
        res = run()
        results[name] = {**res.to_dict(), "wall_s": time.perf_counter() - t0}
        if not res.ok:
            failed.append(f"{name}: {res.error}")
    step_s = spawn_world(burnin_step_seconds, n, "cuda", 10)[0]
    log(json.dumps({"multidevice": {"n_devices": n, "backend": "nccl", **results,
                                    "burnin_step_s": step_s}}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(f"multi-device path on: {smi.stdout.strip() or smi.stderr.strip()}")
    if failed:
        raise RuntimeError(f"the multi-device path failed on {n} cards: {failed}")
    t0 = time.perf_counter()
    dryrun_multichip(n)
    log(f"dryrun_multichip({n}): {time.perf_counter() - t0:.1f} s")


def _smi_cards() -> list:
    """(name, power limit W) of each card, as ``nvidia-smi`` reads them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [
        (name.strip(), float(limit))
        for name, limit in (line.rsplit(",", 1) for line in smi.stdout.strip().splitlines())
    ]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_chip_table(gpuinfo) -> list:
    """The chip table from NVML, each card torch sees found in it by PCI
    bus id (by UUID where NVML gives no bus id, by count and name where
    neither names each card once) with NVML's name equal to torch's, and NVML's names and
    power limits equal to nvidia-smi's; returns the cards' PCI functions as
    torch gives them."""
    chips = gpuinfo.chip_summary()
    log(f"chip table: {json.dumps(chips)}")
    if not chips or any(c["source"] != "nvml" for c in chips):
        raise RuntimeError("the chip table did not come from NVML")
    n = torch.cuda.device_count()
    props = [torch.cuda.get_device_properties(i) for i in range(n)]
    torch_bus = [
        f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"
        if hasattr(p, "pci_bus_id") else None for p in props
    ]
    keys = {
        "PCI bus id": ("pci_address", torch_bus),
        "UUID": ("uuid", [f"GPU-{p.uuid}" if hasattr(p, "uuid") else None for p in props]),
    }
    for how, (field, torch_keys) in keys.items():
        table = {c.get(field): c for c in chips}
        # a key joins only where both sides give it, once a card
        if all([*torch_keys, *table]) and len(set(torch_keys)) == n and len(table) == len(chips):
            missing = [k for k in torch_keys if k not in table]
            if missing:
                raise RuntimeError(f"cards torch sees are not in the chip table: {missing}")
            for i, key in enumerate(torch_keys):
                if table[key]["name"] != torch.cuda.get_device_name(i):
                    raise RuntimeError(f"card {key}: NVML says {table[key]['name']!r}, "
                                       f"torch {torch.cuda.get_device_name(i)!r}")
            log(f"chip table: every card torch sees is in it by {how} {torch_keys}")
            break
        log(f"chip table: no join by {how} (torch {torch_keys}, NVML "
            f"{[c.get(field) for c in chips]})")
    else:
        names = sorted(torch.cuda.get_device_name(i) for i in range(n))
        if len(chips) != n or sorted(c["name"] for c in chips) != names:
            raise RuntimeError(f"the chip table's {len(chips)} cards are not torch's {n}: {names}")
        log(f"chip table: joined by count and name ({n} x {names[0]})")
    if len(chips) != len(gpuinfo.find_gpu_devices()):
        log(f"chip table: /dev holds {gpuinfo.find_gpu_devices()}, NVML {len(chips)} cards")
    # nvidia-smi reads NVML too, so its cards are the table's; identical
    # cards make the sorted (name, limit) pairs a join by bus id
    smi_sorted = sorted((name, limit * 1000.0) for name, limit in _smi_cards())
    nvml_sorted = sorted((c["name"], float(c.get("power_limit_mw", -1))) for c in chips)
    if smi_sorted != nvml_sorted:
        raise RuntimeError(f"NVML's names and power limits {nvml_sorted} are not nvidia-smi's "
                           f"{smi_sorted}")
    log(f"chip table: NVML's names and power limits (mW) equal nvidia-smi's: {nvml_sorted}")
    return [bus for bus in torch_bus if bus]


def check_vfio_refusal(comp, gpuinfo, card_bus, status_dir) -> None:
    """validate_vfio_pci must refuse the cards (bound to nvidia, not
    vfio-pci), naming exactly their PCI functions and no NVSwitch; on a
    machine without a sysfs PCI tree, on a tree written from the cards' bus
    ids beside an NVSwitch function and a foreign one."""
    status = comp.StatusFiles(status_dir)
    real = gpuinfo.SYSFS_PCI
    if os.path.isdir(real):
        tree = real
        log(f"vfio-pci: on the host's {real}")
    else:
        try:
            comp.validate_vfio_pci(status, sysfs=real)
            raise RuntimeError(f"vfio-pci passed with no tree at {real}")
        except comp.ValidationError as e:
            log(f"vfio-pci: the host's {real}: refused: {e}")
        tree = os.path.join(status_dir, "pci")
        functions = {bus: ("0x10de", "0x030200", "nvidia") for bus in card_bus}
        functions["0000:fe:00.0"] = ("0x10de", "0x068000", "nvidia-nvswitch")
        functions["0000:fe:01.0"] = ("0x8086", "0x030000", "i915")
        for addr, (vendor, cls, driver) in functions.items():
            os.makedirs(os.path.join(tree, addr))
            for fname, value in (("vendor", vendor), ("class", cls)):
                with open(os.path.join(tree, addr, fname), "w") as f:
                    f.write(value + "\n")
            os.symlink(f"../../../bus/pci/drivers/{driver}", os.path.join(tree, addr, "driver"))
        log(f"vfio-pci: no PCI tree at {real} here; on one written from the cards' bus ids: "
            f"{sorted(functions)}")
    try:
        comp.validate_vfio_pci(status, sysfs=tree)
        raise RuntimeError("vfio-pci passed although the cards are bound to nvidia")
    except comp.ValidationError as e:
        named = sorted(re.findall(r"[0-9a-f]{4}:[0-9a-f]{2}:[0-9a-f]{2}\.[0-7]", str(e)))
        log(f"vfio-pci refused: {e}")
    for addr in named:
        with open(os.path.join(tree, addr, "vendor")) as f, open(os.path.join(tree, addr, "class")) as g:
            if not gpuinfo.is_card_function(f.read(), g.read()):
                raise RuntimeError(f"vfio-pci named {addr}, which is not a card")
    if tree != real and named != sorted(card_bus):
        raise RuntimeError(f"vfio-pci named {named}, not the cards {sorted(card_bus)}")
    if not set(card_bus) <= set(named):
        raise RuntimeError(f"vfio-pci did not name every card: {named} against {card_bus}")


def run_gang(wp, hosts: int) -> list:
    """One SLICE_GANG_SCRIPT process a card, each with the env
    ``slice_gang_pod`` builds for its ordinal and ``CUDA_VISIBLE_DEVICES``
    its card; returns each rank's output."""
    extra = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    procs = []
    try:
        for rank in range(hosts):
            pod = wp.slice_gang_pod("chip-smoke", "node-0", "default", rank, hosts, extra_env=extra)
            ctr = pod["spec"]["containers"][0]
            if ctr["command"][-1] != wp.SLICE_GANG_SCRIPT:
                raise RuntimeError("the gang pod does not run SLICE_GANG_SCRIPT")
            env = {**os.environ, **{e["name"]: e["value"] for e in ctr["env"]},
                   "CUDA_VISIBLE_DEVICES": str(rank)}
            procs.append(subprocess.Popen([sys.executable, "-c", ctr["command"][-1]], env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        outs = []
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=180)
            if proc.returncode != 0:
                raise RuntimeError(f"gang of {hosts}, rank {rank}: rc={proc.returncode}\n{err[-2000:]}")
            outs.append(out.strip())
        return outs
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phase_node_agents() -> None:
    """The node agents on the card (phase 6); raises on any miss."""
    from tpu_operator_torch import _build
    from tpu_operator_torch.metricsd.daemon import MetricsDaemon
    from tpu_operator_torch.native import gpuinfo
    from tpu_operator_torch.operands import devchar
    from tpu_operator_torch.plugin.cdi import write_spec
    from tpu_operator_torch.validator import components as comp
    from tpu_operator_torch.validator import workload_pods as wp
    from tpu_operator_torch.validator.metrics import NodeMetrics

    t_phase = time.perf_counter()
    _build.reset_launches()
    n = torch.cuda.device_count()
    card_bus = check_chip_table(gpuinfo)
    chips = gpuinfo.chip_summary()

    nodes = gpuinfo.find_gpu_devices()
    alive = {p: gpuinfo.device_probe_path(p) for p in nodes}
    log(f"device_probe_path: {alive}")
    if not nodes or not all(alive.values()):
        raise RuntimeError(f"a card node failed its open probe: {alive}")

    with tempfile.TemporaryDirectory(prefix="chip-smoke-agents-") as tmp:
        char_dir = os.path.join(tmp, "char")
        created = devchar.create_dev_char_symlinks("/dev", char_dir)
        log(f"devchar: {len(created)} links into {char_dir}: "
            f"{sorted(os.path.basename(c) for c in created)}")
        for c in chips:
            link = os.path.join(char_dir, f"195:{c['index']}")
            if not os.path.islink(link) or os.readlink(link) != c["path"]:
                raise RuntimeError(f"no /dev/char link 195:{c['index']} to {c['path']}")

        # the host checks through the CLI; the links were made above, so
        # the driver component makes none in the host's /dev/char
        status_dir = os.path.join(tmp, "validations")
        env = {**os.environ, devchar.DISABLE_ENV: "true"}
        cdi = None
        for d in ("/var/run/cdi", "/etc/cdi"):
            for path in sorted(glob.glob(os.path.join(d, "*.json"))):
                with open(path) as f:
                    if json.load(f).get("kind") == "nvidia.com/gpu":
                        cdi = cdi or path
        if cdi is None:
            cdi = os.path.join(tmp, "nvidia.json")
            write_spec(cdi, driver_root="/", chips=chips)
            log(f"toolkit: no JSON CDI spec naming nvidia.com/gpu in /var/run/cdi or /etc/cdi; "
                f"on {cdi}, written from the chip table by cdi.write_spec")
        else:
            log(f"toolkit: on the host's CDI spec {cdi}")
        for component, args, status_file in (
            ("driver", ["--driver-root", "/"], "driver-ready"),
            ("toolkit", ["--cdi-spec", cdi], "toolkit-ready"),
        ):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "tpu_operator_torch.validator", "--component", component,
                 *args, "--output-dir", status_dir],
                capture_output=True, text=True, timeout=120, env=env,
            )
            wall = time.perf_counter() - t0
            path = os.path.join(status_dir, status_file)
            if proc.returncode != 0 or not os.path.exists(path):
                raise RuntimeError(f"CLI {component} failed rc={proc.returncode}:\n"
                                   f"{proc.stderr[-3000:]}")
            with open(path) as f:
                payload = json.load(f)
            log(f"cli {component}: rc=0 {wall:.2f} s {status_file}={json.dumps(payload)}")
            if component == "driver" and (
                not payload["libcuda"] or not payload["libnvidia_ml"]
                or [c["index"] for c in payload["chips"]] != [c["index"] for c in chips]
                or any(c["source"] != "nvml" for c in payload["chips"])
            ):
                raise RuntimeError("driver-ready lacks the libraries or NVML's chip table")
            if component == "toolkit" and not payload["devices"]:
                raise RuntimeError("toolkit-ready lists no devices")

        check_vfio_refusal(comp, gpuinfo, card_bus, os.path.join(tmp, "vfio"))

        daemon = MetricsDaemon(own_chip=True, drop_file=os.path.join(tmp, "metricsd.json"),
                               interval_s=3600.0)
        sample = daemon.collect_once()
        utils = [c.get("tensorcore_util") for c in sample["chips"]]
        log(f"metricsd: tensorcore_util {utils} from {daemon.last_sample_tflops} TFLOPS "
            f"(one 2048^2 bf16 product, host-timed)")
        if not utils or not all(u is not None and 0 < u <= 100 for u in utils):
            raise RuntimeError(f"tensorcore_util out of (0, 100]: {utils}")
        port = _free_port()
        server = daemon.serve(port=port, block=False)
        try:
            deadline = time.time() + 60
            while daemon.latest().get("ts") == sample["ts"] and time.time() < deadline:
                time.sleep(0.05)  # the serving loop's own first collection
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as r:
                got = json.loads(r.read())
            if got != daemon.latest():
                raise RuntimeError(f"metricsd GET {got} is not latest() {daemon.latest()}")
            log(f"metricsd: GET :{port} equals latest(): {json.dumps(got)}")
        finally:
            daemon.stop()
            server.shutdown()
            server.server_close()

        for name, script in (("matmul", wp.CUDA_MATMUL_SCRIPT), ("plugin", wp.PLUGIN_SMOKE_SCRIPT)):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                                  timeout=180)
            if proc.returncode != 0:
                raise RuntimeError(f"the {name} pod script failed:\n{proc.stderr[-2000:]}")
            log(f"{name} pod script: rc=0 {time.perf_counter() - t0:.2f} s: {proc.stdout.strip()}")
        for hosts in (1, 2) if n >= 2 else (1,):
            t0 = time.perf_counter()
            outs = run_gang(wp, hosts)
            log(f"gang of {hosts}: rc=0 {time.perf_counter() - t0:.2f} s: {outs}")

        nm = NodeMetrics(status=comp.StatusFiles(status_dir), driver_root="/", dev_root="/dev")
        passes = {"status": nm.status_pass(), "driver_validation": nm.driver_pass(),
                  "gpu_capacity": nm.capacity_pass(), "gpu_devices": nm.devices_pass()}
        log(f"node-status passes: {json.dumps(passes)}")
        if passes["gpu_devices"] != n or passes["driver_validation"] != 1:
            raise RuntimeError(f"node-status: gpu_devices {passes['gpu_devices']} (cards {n}), "
                               f"driver_validation {passes['driver_validation']}")
        if passes["status"]["ready"] != {"driver-ready": 1, "toolkit-ready": 1,
                                         "plugin-ready": 0, "cuda-ready": 0}:
            raise RuntimeError(f"node-status: readiness {passes['status']['ready']}")

    launched = {k: v for k, v in _build.launches.items() if v}
    if launched:
        raise RuntimeError(f"the node agents launched kernels of the package: {launched}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(f"node agents on: {smi.stdout.strip() or smi.stderr.strip()}; no kernel of the package "
        f"launched; phase 6 {time.perf_counter() - t_phase:.1f} s")


class _PluginDriver:
    """The device plugin as the kubelet drives it: over gRPC through a stub
    on its unix socket where grpc and protobuf import, else through the
    servicer's plain-data methods (``watch``, ``preferred``,
    ``allocate_container``), with no server."""

    def __init__(self, plugin, servicer, socket_dir: str, transport: str):
        self.servicer, self.transport = servicer, transport
        self.server = self.channel = self.stream = None
        if transport == "grpc":
            import grpc

            from tpu_operator_torch.plugin import grpc_glue
            from tpu_operator_torch.plugin.proto import deviceplugin_pb2 as pb2

            self.pb2 = pb2
            self.server = plugin.DevicePluginServer(servicer, socket_dir=socket_dir)
            if len(self.server.socket_path) > 107:
                raise RuntimeError(f"socket path longer than 107 bytes: {self.server.socket_path}")
            self.channel = grpc.insecure_channel(self.server.start())
            self.stub = grpc_glue.DevicePluginStub(self.channel)
            self.stream = self.stub.ListAndWatch(pb2.Empty(), timeout=PLUGIN_TIMEOUT_S)
        else:
            self.stream = servicer.watch()

    def next_list(self) -> dict:
        """The stream's next message as {id: health}."""
        msg = next(self.stream)
        if self.transport == "grpc":
            return {d.ID: d.health for d in msg.devices}
        return {d["ID"]: d["health"] for d in msg}

    def prefer(self, available, must, size) -> list:
        if self.transport != "grpc":
            return self.servicer.preferred(available, must, size)
        req = self.pb2.GetPreferredAllocationRequest()
        creq = req.container_requests.add()
        creq.available_deviceIDs.extend(available)
        creq.must_include_deviceIDs.extend(must)
        creq.allocation_size = size
        resp = self.stub.GetPreferredAllocation(req, timeout=PLUGIN_TIMEOUT_S)
        return list(resp.container_responses[0].deviceIDs)

    def allocate(self, ids) -> tuple:
        """(CDI device names, env) of one container's Allocate."""
        if self.transport != "grpc":
            content = self.servicer.allocate_container(ids)
            return content["cdi_devices"], content["envs"]
        req = self.pb2.AllocateRequest()
        req.container_requests.add().devicesIDs.extend(ids)
        cresp = self.stub.Allocate(req, timeout=PLUGIN_TIMEOUT_S).container_responses[0]
        return [c.name for c in cresp.cdi_devices], dict(cresp.envs)

    def close(self) -> None:
        """Cancel the stream, stop the server and join the poller."""
        if self.transport == "grpc":
            self.stream.cancel()
            self.channel.close()
            self.server.stop()
        else:
            self.stream.close()
            self.servicer.stop()
        poller = self.servicer._poller
        if poller is not None and poller.is_alive():
            raise RuntimeError("the plugin's poller outlived stop()")


def container_view(got, envs, uuid) -> None:
    """A process started with Allocate's env ``envs`` sees exactly the
    allocated cards ``got`` (by UUID)."""
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CONTAINER_VIEW_SCRIPT],
                          env={**os.environ, **envs}, capture_output=True, text=True, timeout=180)
    if proc.returncode != 0:
        raise RuntimeError(f"the container view of {got} failed:\n{proc.stderr[-2000:]}")
    count, seen = json.loads(proc.stdout.strip().splitlines()[-1])
    if count != len(got) or sorted(seen) != sorted(uuid[i] for i in got):
        raise RuntimeError(f"allocated {got} ({[uuid[i] for i in got]}); the process saw "
                           f"{count} cards {seen}")
    log(f"container view of {got}: {count} card(s), {seen}, {time.perf_counter() - t1:.2f} s")


def check_features(feats, n) -> None:
    """Feature discovery's product, count, memory and driver-version labels
    equal ``nvidia-smi``'s."""
    from tpu_operator_torch import consts

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,memory.total,driver_version", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    rows = [[x.strip() for x in line.split(",")] for line in smi.stdout.strip().splitlines()]
    want = {
        consts.GPU_PRODUCT_LABEL: rows[0][0].replace(" ", "-"),
        consts.GPU_COUNT_LABEL: str(n),
        consts.GPU_MEMORY_LABEL: rows[0][1],
        consts.DRIVER_VERSION_LABEL: rows[0][2],
    }
    got = {k: feats.get(k) for k in want}
    if got != want or len(rows) != n:
        raise RuntimeError(f"feature discovery {got} against nvidia-smi {want} ({len(rows)} rows)")


def node_caps(client, name) -> tuple:
    """(capacity, allocatable) of ``nvidia.com/gpu`` on a node."""
    from tpu_operator_torch import consts

    st = client.get("v1", "Node", name).get("status", {})
    return st.get("capacity", {}).get(consts.GPU_RESOURCE), st.get("allocatable", {}).get(consts.GPU_RESOURCE)


def kubelet_capacity(plugin, node_client, socket_dir: str, n: int) -> float:
    """The port's kubelet registers a fresh plugin over the card over gRPC
    and writes the node's capacity and allocatable into ``node_client``;
    both must reach ``n`` within ``PLUGIN_TIMEOUT_S``. Returns the ms from
    registration to the write."""
    from tpu_operator_torch.kube import kubelet_sim

    kubelet = kubelet_sim.KubeletDeviceManager(node_client, OPERANDS_NODE, socket_dir)
    servicer = plugin.GPUDevicePluginServicer(dev_root="/dev", driver_root="/", poll_interval_s=0.2,
                                              health_probe_interval_s=3600)
    server = plugin.DevicePluginServer(servicer, socket_dir=socket_dir)
    try:
        kubelet.start()
        server.start()
        t0 = time.perf_counter()
        server.register_with_kubelet(kubelet.kubelet_socket)
        _wait_for("the kubelet's capacity", lambda: node_caps(node_client, OPERANDS_NODE) == (str(n),) * 2,
                  PLUGIN_TIMEOUT_S)
        return (time.perf_counter() - t0) * 1e3
    finally:
        server.stop()
        kubelet.stop()


def phase_device_stack() -> None:
    """The card advertised (phase 7); raises on any miss."""
    from tpu_operator_torch import _build
    from tpu_operator_torch import consts
    from tpu_operator_torch.discovery import tfd
    from tpu_operator_torch.kube.client import FakeClient
    from tpu_operator_torch.native import gpuinfo
    from tpu_operator_torch.operands import runtime_wire
    from tpu_operator_torch.plugin import server as plugin
    from tpu_operator_torch.validator import components as comp
    from tpu_operator_torch.validator.metrics import NodeMetrics

    t_phase = time.perf_counter()
    _build.reset_launches()
    n = torch.cuda.device_count()
    chips = gpuinfo.chip_summary()
    ids = [str(c["index"]) for c in chips]
    uuid = {str(c["index"]): c.get("uuid") for c in chips}
    if len(chips) != n or any(c["source"] != "nvml" or not c.get("uuid") for c in chips):
        raise RuntimeError(f"the chip table does not name torch's {n} cards by UUID: {chips}")
    try:
        import grpc  # noqa: F401

        from tpu_operator_torch.plugin.proto import deviceplugin_pb2  # noqa: F401

        transport = "grpc"
        log(f"device stack: grpc {grpc.__version__} and protobuf import; the plugin is served "
            f"over gRPC on a unix socket")
    except ImportError as e:
        transport = "plain"
        log(f"device stack: grpc or protobuf does not import here ({e}); the plugin is held "
            f"through its plain-data methods, with no gRPC server")

    with tempfile.TemporaryDirectory(prefix="cs7-") as tmp:
        # 1. the CDI spec from the chip table, and the toolkit component on it
        spec_path = os.path.join(tmp, "nvidia.json")
        spec = runtime_wire.wire_once(spec_path, dev_root="/dev", driver_root="/", chips=chips)
        spec_names = {d["name"] for d in spec["devices"]}
        status_dir = os.path.join(tmp, "validations")
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_operator_torch.validator", "--component", "toolkit",
             "--cdi-spec", spec_path, "--output-dir", status_dir],
            capture_output=True, text=True, timeout=120,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"CLI toolkit failed on the runtime wire's spec:\n{proc.stderr[-3000:]}")
        with open(os.path.join(status_dir, consts.STATUS_FILE_TOOLKIT)) as f:
            payload = json.load(f)
        if payload["devices"] != ids + ["all"]:
            raise RuntimeError(f"toolkit-ready lists {payload['devices']}, not the cards {ids} and all")
        log(f"runtime wire: CDI spec {spec_path} with devices {payload['devices']}, "
            f"{len(spec['containerEdits']['mounts'])} driver libraries, control nodes "
            f"{[d['path'] for d in spec['containerEdits']['deviceNodes']]}; cli toolkit rc=0")

        # 2. the device plugin, all of it under a watchdog: a stream left
        # open would hang the phase
        faulthandler.dump_traceback_later(PLUGIN_TIMEOUT_S, exit=True)
        try:
            t0 = time.perf_counter()
            servicer = plugin.GPUDevicePluginServicer(
                dev_root="/dev", driver_root="/", poll_interval_s=0.2, health_probe_interval_s=3600
            )
            drv = _PluginDriver(plugin, servicer, os.path.join(tmp, "k"), transport)
            try:
                first = drv.next_list()
                first_s = time.perf_counter() - t0
                if sorted(first, key=int) != ids or set(first.values()) != {"Healthy"}:
                    raise RuntimeError(f"first advertisement {first}, not the chip table's {ids} Healthy")
                servicer.mark_unhealthy(ids[0])
                flipped = drv.next_list()
                if flipped[ids[0]] != "Unhealthy" or sum(h == "Healthy" for h in flipped.values()) != n - 1:
                    raise RuntimeError(f"mark_unhealthy({ids[0]}) streamed {flipped}")
                servicer.mark_healthy(ids[0])
                advert = drv.next_list()
                if set(advert.values()) != {"Healthy"}:
                    raise RuntimeError(f"mark_healthy({ids[0]}) streamed {advert}")
                log(f"plugin ({transport}): first advertisement {first} after {first_s * 1e3:.1f} ms; "
                    f"card {ids[0]} Unhealthy and back")

                requests = [(ids, [], 1)]
                if n >= 2:
                    requests.append((ids, [ids[-1]], 2))
                allocations = []
                for available, must, size in requests:
                    got = drv.prefer(available, must, size)
                    if len(got) != size or len(set(got)) != size or not set(must) <= set(got) <= set(ids):
                        raise RuntimeError(
                            f"GetPreferredAllocation({available}, must {must}, {size}) = {got}")
                    t1 = time.perf_counter()
                    names, envs = drv.allocate(got)
                    alloc_ms = (time.perf_counter() - t1) * 1e3
                    want_names = [f"{consts.CDI_KIND}={i}" for i in got]
                    if names != want_names or any(x.split("=", 1)[1] not in spec_names for x in names):
                        raise RuntimeError(
                            f"Allocate({got}) named {names}; the spec has {sorted(spec_names)}")
                    visible = ",".join(uuid[i] for i in sorted(got, key=int))
                    if (envs.get("NVIDIA_VISIBLE_DEVICES"), envs.get("CUDA_VISIBLE_DEVICES")) != (visible,) * 2:
                        raise RuntimeError(f"Allocate({got}) env {envs} does not name {visible}")
                    log(f"plugin: preferred {got} (must {must}); Allocate round trip {alloc_ms:.2f} ms, "
                        f"CDI {names}")
                    allocations.append((got, envs))
            finally:
                drv.close()
        finally:
            faulthandler.cancel_dump_traceback_later()

        # 3. a container with Allocate's env sees exactly its cards
        for got, envs in allocations:
            container_view(got, envs, uuid)

        # 4. the plugin component on the node's capacity: the port's kubelet
        # writes it into a FakeClient node from the plugin's advertisement
        # over gRPC; without grpc the script writes the advertisement's
        node_client = FakeClient([{"apiVersion": "v1", "kind": "Node",
                                   "metadata": {"name": OPERANDS_NODE, "labels": {}}}])
        if transport == "grpc":
            kubelet_ms = kubelet_capacity(plugin, node_client, os.path.join(tmp, "kl"), n)
            log(f"kubelet: the port's KubeletDeviceManager wrote capacity {n} {kubelet_ms:.1f} ms "
                f"after the plugin registered")
        else:
            node = node_client.get("v1", "Node", OPERANDS_NODE, copy=True)
            node["status"] = {
                "capacity": {consts.GPU_RESOURCE: str(len(advert))},
                "allocatable": {consts.GPU_RESOURCE: str(sum(h == "Healthy" for h in advert.values()))},
            }
            node_client.update(node)
        status = comp.StatusFiles(status_dir)
        info = comp.validate_plugin(status, node_client, OPERANDS_NODE, retries=1, sleep_s=0)
        ready = NodeMetrics(status=status, driver_root="/", dev_root="/dev").status_pass()["ready"]
        if (info["capacity"], info["allocatable"]) != (n, n) or ready["plugin-ready"] != 1:
            raise RuntimeError(f"plugin component: {info}, readiness {ready}")
        log(f"plugin component: {json.dumps(info)}; node-status readiness {json.dumps(ready)}")

    # 5. feature discovery against nvidia-smi
    feats = tfd.gather_features({"metadata": {"name": OPERANDS_NODE, "labels": {}}},
                                dev_root="/dev", driver_root="/", env={})
    check_features(feats, n)
    log(f"feature discovery: {json.dumps(feats)}; the four labels equal nvidia-smi's")

    launched = {k: v for k, v in _build.launches.items() if v}
    if launched:
        raise RuntimeError(f"the device stack launched kernels of the package: {launched}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"device stack on: {smi.stdout.strip() or smi.stderr.strip()}; transport {transport}; "
        f"first advertisement {first_s * 1e3:.1f} ms; no kernel of the package launched; "
        f"phase 7 {time.perf_counter() - t_phase:.1f} s")


# phase 8: the node's operands
BUSY_S = 1.0  # the torch.mm load the busy exporter pass reads
EXPORTED_NAMES = ("gpu_duty_cycle_percent", "gpu_memory_used_bytes", "gpu_memory_total_bytes",
                  "gpu_tensorcore_utilization_percent", "gpu_temperature_celsius", "gpu_present",
                  "gpu_nvlink_pairs_total")


def check_slice_manager(tmp, chips, n) -> None:
    """A node labelled by feature discovery, one slice a card and (two or
    more cards) 1x2: each reconcile succeeds, its subslices cover exactly
    the chip table's minors inside one NVLink domain each, the CDI spec's
    composites hold exactly their cards' nodes and the plugin advertises
    one ``nvidia.com/mig-<shape>`` device a subslice; a shape that does not
    tile the host fails."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.discovery import tfd
    from tpu_operator_torch.kube.client import ConflictError, FakeClient
    from tpu_operator_torch.plugin.manager import PluginManager
    from tpu_operator_torch.sliceman import slice_manager as sm
    from tpu_operator_torch.workloads import topology as topo

    client_label = consts.DEPLOY_LABEL_PREFIX + "device-plugin"
    node = {"apiVersion": "v1", "kind": "Node", "metadata": {"name": OPERANDS_NODE, "labels": {}}}
    labels = tfd.gather_features(node, dev_root="/dev", driver_root="/", env={}, chips=chips)
    node["metadata"]["labels"] = {**labels, client_label: "true"}
    store = FakeClient([node])
    stale = store.get("v1", "Node", OPERANDS_NODE)
    store.update(store.get("v1", "Node", OPERANDS_NODE))
    try:
        store.update(stale)
        raise RuntimeError("the store took a write from a stale read")
    except ConflictError:
        pass
    profiles = {"all-1x1": "1x1", **({"all-1x2": "1x2"} if n >= 2 else {})}
    bad = "1x3" if n % 3 else f"1x{n + 1}"
    configs = {name: [{"devices": "all", "partitioned": True, "layout": {"shape": shape}}]
               for name, shape in {**profiles, "bad": bad}.items()}
    config_file, clients_file = os.path.join(tmp, "slice-configs.yaml"), os.path.join(tmp, "clients.yaml")
    with open(config_file, "w") as f:
        json.dump({"version": "v1", "slice-configs": configs}, f)  # JSON is YAML
    with open(clients_file, "w") as f:
        json.dump({"version": "v1", "kubernetes-labels": [client_label]}, f)
    partition_file, spec_path = os.path.join(tmp, "partitions.json"), os.path.join(tmp, "cdi", "nvidia.json")
    mgr = sm.SliceManager(store, OPERANDS_NODE, config_file=config_file, chip_clients_file=clients_file,
                          partition_file=partition_file, cdi_spec_path=spec_path, dev_root="/dev",
                          driver_root="/")
    cards = {c["index"]: c for c in chips}
    log(f"slice manager: node labels from feature discovery {json.dumps(labels)}")
    for name, shape in {**profiles, "bad": bad}.items():
        node = store.get("v1", "Node", OPERANDS_NODE, copy=True)
        node["metadata"]["labels"][consts.SLICE_CONFIG_LABEL] = name
        store.update(node)
        t0 = time.perf_counter()
        state = mgr.reconcile_once()
        wall_ms = (time.perf_counter() - t0) * 1e3
        labels = store.get("v1", "Node", OPERANDS_NODE)["metadata"]["labels"]
        want = sm.STATE_FAILED if name == "bad" else sm.STATE_SUCCESS
        if state != want or labels[consts.SLICE_CONFIG_STATE_LABEL] != want or labels[client_label] != "true":
            raise RuntimeError(f"slice config {name} ({shape}): {state}, labels {labels}")
        if name == "bad":
            log(f"slice manager: {shape} on {labels[consts.TFD_TOPOLOGY_LABEL]} -> {state} in "
                f"{wall_ms:.1f} ms; clients restored")
            continue
        part = sm.read_partition_state(partition_file)
        subs = part["subslices"]
        ids = sorted(c for sub in subs for c in sub["chips"])
        if ids != sorted(cards) or any(not topo.contiguous(sub["chips"], cards) for sub in subs):
            raise RuntimeError(f"partition {subs} is not the chip table's {sorted(cards)} in domains")
        with open(spec_path) as f:
            spec = json.load(f)
        composites = {d["name"]: sorted(x["path"] for x in d["containerEdits"]["deviceNodes"])
                      for d in spec["devices"] if d["name"].startswith("subslice-")}
        want_nodes = {f"subslice-{sub['id']}-{sub['shape']}": sorted(f"/dev/nvidia{c}" for c in sub["chips"])
                      for sub in subs}
        if composites != want_nodes:
            raise RuntimeError(f"CDI composites {composites}, not {want_nodes}")
        res = PluginManager(strategy="mixed", partition_file=partition_file).desired_resources()
        got = {k: len(v.get("subslices", [])) for k, v in res.items()}
        if got != {consts.MIG_RESOURCE_PREFIX + shape: len(subs)}:
            raise RuntimeError(f"the plugin advertises {got} for {len(subs)} subslices of {shape}")
        log(f"slice manager: {name} -> {state} in {wall_ms:.1f} ms; subslices "
            f"{[sub['chips'] for sub in subs]} (generation {part['generation']!r}); CDI {composites}; "
            f"plugin resources {got}")


def exporter_pass(ex, prom: bool, chips, endpoint: str = "") -> tuple:
    """({chip: {key: value}}, {(key, chip): source}) of one exporter pass;
    through ``Exporter.collect_once`` where prometheus_client imports."""
    if prom:
        from prometheus_client import CollectorRegistry

        exp = ex.Exporter(node_name=OPERANDS_NODE, registry=CollectorRegistry(), metricsd_endpoint=endpoint)
        values = exp.collect_once()
        return values, {(k, c): s for k, c, s in exp._last_series}
    from tpu_operator_torch.native import gpuinfo

    data = ex.fetch_metricsd(endpoint) or gpuinfo.metrics(chips=chips)
    values, series = ex.collect_values(data, ex.DEFAULT_METRICS, chips)
    return values, {(k, c): s for (k, c, s), _ in series}


def busy_exporter_pass(ex, prom, chips) -> tuple:
    """An exporter pass while ~``BUSY_S`` of 8192^2 bf16 products run on
    cuda:0: the products are queued first, the pass reads NVML half way."""
    a = torch.randn(8192, 8192, dtype=torch.bfloat16, device="cuda:0")
    b, c = torch.randn_like(a), torch.empty_like(a)
    ms = time_ms(lambda: torch.mm(a, b, out=c), 5)
    for _ in range(int(BUSY_S * 1e3 / ms) + 1):
        torch.mm(a, b, out=c)  # the host blocks once the launch queue is full
    time.sleep(BUSY_S / 2)
    try:
        return exporter_pass(ex, prom, chips)
    finally:
        torch.cuda.synchronize()


def check_exporter(tmp, chips, n) -> None:
    """One exporter pass over NVML idle and one under load (each series'
    source printed), one through the metrics daemon's sampler, and the
    ``/metrics`` text where prometheus_client imports."""
    from tpu_operator_torch.exporter import exporter as ex
    from tpu_operator_torch.metricsd.daemon import MetricsDaemon
    from tpu_operator_torch.workloads import topology as topo

    try:
        import prometheus_client

        prom = True
        log(f"exporter: prometheus_client imports ({getattr(prometheus_client, '__version__', 'no version')})")
    except ImportError as e:
        prom = False
        log(f"exporter: prometheus_client does not import ({e}); the values are held without gauges")
    gen = topo.device_generation(chips[0]["name"])
    if gen is None:
        raise RuntimeError(f"no variant for {chips[0]['name']!r}")
    values, sources = exporter_pass(ex, prom, chips)
    log(f"exporter idle: {json.dumps(values)}; sources {json.dumps({f'{k}/{c}': s for (k, c), s in sorted(sources.items())})}")
    for chip in chips:
        cid = str(chip["index"])
        v = values.get(cid, {})
        if v.get("present") != 1.0 or sources[("present", cid)] != "devfs":
            raise RuntimeError(f"card {cid}: present {v.get('present')}")
        if v.get("hbm_total") != topo.HBM_GB[gen] * 2**30 or sources[("hbm_total", cid)] != "spec":
            raise RuntimeError(f"card {cid}: hbm_total {v.get('hbm_total')}, not {gen}'s {topo.HBM_GB[gen]} GiB")
        if "duty_cycle" in v and not (0 <= v["duty_cycle"] <= 100 and sources[("duty_cycle", cid)] == "nvml"):
            raise RuntimeError(f"card {cid}: duty_cycle {v['duty_cycle']} from {sources[('duty_cycle', cid)]}")
        if "hbm_used" in v and not v["hbm_used"] <= chip.get("memory_total_bytes", 0):
            raise RuntimeError(f"card {cid}: hbm_used {v['hbm_used']} above NVML's total")
        if v.get("ici_links") != topo.nvlink_pair_count({c["index"]: c for c in chips}):
            raise RuntimeError(f"card {cid}: ici_links {v.get('ici_links')}")
    busy, _ = busy_exporter_pass(ex, prom, chips)
    first = str(chips[0]["index"])
    log(f"exporter: duty_cycle idle {values[first].get('duty_cycle')} busy {busy[first].get('duty_cycle')}; "
        f"hbm_used idle {values[first].get('hbm_used')} busy {busy[first].get('hbm_used')}; "
        f"temperature idle {values[first].get('temperature')} busy {busy[first].get('temperature')} "
        f"(card {first}, NVML; ~{BUSY_S} s of torch.mm on cuda:0)")

    port = _free_port()
    daemon = MetricsDaemon(own_chip=True, drop_file=os.path.join(tmp, "metricsd.json"), interval_s=3600.0)
    server = daemon.serve(port=port, block=False)
    try:
        deadline = time.time() + 60
        while not daemon.latest()["chips"] and time.time() < deadline:
            time.sleep(0.05)
        sampled, sources = exporter_pass(ex, prom, chips, endpoint=f"127.0.0.1:{port}")
    finally:
        daemon.stop()
        server.shutdown()
        server.server_close()
    util = {c: (v.get("tensorcore_util"), sources.get(("tensorcore_util", c))) for c, v in sampled.items()}
    log(f"exporter through metricsd :{port}: tensorcore_util {util}")
    if sorted(util, key=int) != [str(c["index"]) for c in chips] or any(s != "sampler" for _, s in util.values()):
        raise RuntimeError(f"tensorcore_util not from the sampler on every card: {util}")

    if prom:
        from prometheus_client import CollectorRegistry

        exp = ex.Exporter(node_name=OPERANDS_NODE, registry=CollectorRegistry(), interval_s=3600.0)
        port = _free_port()
        served = exp.run(port=port, block=False)
        try:
            text, deadline = "", time.time() + 60
            while "gpu_present{" not in text and time.time() < deadline:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                    text = r.read().decode()
                time.sleep(0.05)
        finally:
            exp.stop()
            if isinstance(served, tuple):
                served[0].shutdown()
                served[0].server_close()
        names = sorted({line.split("{", 1)[0] for line in text.splitlines()
                        if line.startswith("gpu_") and "{" in line})
        exported = sorted(ex.ALL_METRICS[k][0] for k in {k for v in values.values() for k in v})
        if names != exported or "tpu_" in text:
            raise RuntimeError(f"/metrics names {names}, not {exported}")
        log(f"exporter: GET /metrics :{port} names {names}")


def check_driver_installer(tmp, comp) -> None:
    """A payload of the machine's own libcuda and libnvidia-ml (the
    targets of their .so.1 links) installed into a temporary driver root:
    the ``driver`` component passes on it, VERSION is NVML's driver
    version, and after ``uninstall`` the component fails."""
    from tpu_operator_torch.native import gpuinfo
    from tpu_operator_torch.operands import devchar, driver_installer

    libs = comp.find_driver_libraries("/")
    payload, root = os.path.join(tmp, "payload"), os.path.join(tmp, "driver")
    os.makedirs(payload)
    for key, name in (("libcuda", "libcuda"), ("libnvidia_ml", "libnvidia-ml")):
        links = [p for p in libs[key] if os.path.basename(p) == f"{name}.so.1"]
        if not links:
            raise RuntimeError(f"no {name}.so.1 under / ({libs[key]})")
        target = os.path.realpath(links[0])
        os.symlink(target, os.path.join(payload, os.path.basename(target)))
    t0 = time.perf_counter()
    version = driver_installer.install(payload, root)
    install_s = time.perf_counter() - t0
    nvml_version = gpuinfo.driver_version()
    with open(os.path.join(root, driver_installer.LIB_DIR, "VERSION")) as f:
        recorded = f.read().strip()
    if not (version == recorded == nvml_version):
        raise RuntimeError(f"installed {version}, VERSION {recorded}, NVML {nvml_version}")
    env = {**os.environ, devchar.DISABLE_ENV: "true"}
    status_dir = os.path.join(tmp, "validations")
    for installed in (True, False):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_operator_torch.validator", "--component", "driver",
             "--driver-root", root, "--output-dir", status_dir],
            capture_output=True, text=True, timeout=120, env=env,
        )
        wall = time.perf_counter() - t0
        if installed:
            if proc.returncode != 0:
                raise RuntimeError(f"driver component on the install: rc={proc.returncode}\n{proc.stderr[-2000:]}")
            with open(os.path.join(status_dir, "driver-ready")) as f:
                payload_libs = json.load(f)["libcuda"]
            if not payload_libs or not all(p.startswith(root) for p in payload_libs):
                raise RuntimeError(f"driver-ready names {payload_libs}, not the install under {root}")
            log(f"driver installer: {sorted(os.listdir(payload))} -> {root} in {install_s:.2f} s, "
                f"VERSION {recorded} == NVML's; cli driver --driver-root <install> rc=0 {wall:.2f} s, "
                f"libcuda {[os.path.basename(p) for p in payload_libs]}")
            driver_installer.uninstall(root)
        elif proc.returncode == 0 or "libcuda.so not found" not in proc.stderr:
            raise RuntimeError(f"driver component after uninstall: rc={proc.returncode}\n{proc.stderr[-2000:]}")
        else:
            log(f"driver installer: after uninstall cli driver rc={proc.returncode} {wall:.2f} s: "
                f"{proc.stderr.strip().splitlines()[-1]}")


def check_driver_manager(tmp, comp) -> None:
    """``uninstall_gpu_driver`` on the store: the pod that requests a card
    is evicted, the one that requests nothing stays, and the five
    barriers are gone."""
    from tpu_operator_torch.kube.client import FakeClient
    from tpu_operator_torch.operands import driver_manager

    def pod(name, resources):
        return {"apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": name, "namespace": "default",
                             "ownerReferences": [{"kind": "Job", "name": name, "uid": name}]},
                "spec": {"nodeName": OPERANDS_NODE, "containers": [{"resources": resources}]}}

    store = FakeClient([pod("gpu-job", {"limits": {"nvidia.com/gpu": "1"}}), pod("cpu-job", {})])
    status = comp.StatusFiles(os.path.join(tmp, "manager"))
    for name in driver_manager.BARRIERS:
        status.write(name)
    t0 = time.perf_counter()
    rc = driver_manager.uninstall_gpu_driver(store, OPERANDS_NODE, status, eviction_timeout_s=30)
    left = [p["metadata"]["name"] for p in store.list("v1", "Pod")]
    if rc != 0 or left != ["cpu-job"] or any(status.exists(b) for b in driver_manager.BARRIERS):
        raise RuntimeError(f"driver manager: rc={rc}, pods left {left}")
    log(f"driver manager: rc=0 in {(time.perf_counter() - t0) * 1e3:.1f} ms; evicted gpu-job, kept "
        f"{left}; barriers {list(driver_manager.BARRIERS)} cleared")


def check_sandbox_operands(tmp, comp, chips) -> None:
    """The vfio manager on a PCI tree written from the chip table beside an
    NVSwitch and a foreign function (never the host's /sys/bus/pci: it
    would unbind the cards under test), the vm and vm-device managers on a
    vfio tree of one group a card, and kata's snippet; each component
    passes on what its operand wrote."""
    from tpu_operator_torch.operands import vfio_manager, vm_manager

    pci = os.path.join(tmp, "pci")
    os.makedirs(os.path.join(pci, "drivers", "vfio-pci"))
    open(os.path.join(pci, "drivers_probe"), "w").close()
    cards = [c.get("pci_address") or f"0000:{0x18 + i:02x}:00.0" for i, c in enumerate(chips)]
    functions = {addr: ("0x10de", "0x030200", "nvidia") for addr in cards}
    functions["0000:fe:00.0"] = ("0x10de", "0x068000", "nvidia-nvswitch")
    functions["0000:fe:01.0"] = ("0x8086", "0x030000", "i915")
    for addr, (vendor, cls, driver) in functions.items():
        d = os.path.join(pci, "devices", addr)
        os.makedirs(d)
        for fname, value in (("vendor", vendor), ("class", cls), ("driver_override", "")):
            with open(os.path.join(d, fname), "w") as f:
                f.write(value + "\n" if value else "")
        os.makedirs(os.path.join(pci, "drivers", driver), exist_ok=True)
        open(os.path.join(pci, "drivers", driver, "unbind"), "w").close()
        os.symlink(os.path.join(pci, "drivers", driver), os.path.join(d, "driver"))
    write = vfio_manager._write

    def kernel_write(path, value):
        # the kernel's part on a fixture tree: drivers_probe binds by
        # driver_override, an unbind write drops the driver link
        write(path, value)
        dev = os.path.join(pci, "devices", value.strip())
        if path.endswith("drivers_probe"):
            with open(os.path.join(dev, "driver_override")) as f:
                if f.read() == "vfio-pci" and not os.path.islink(os.path.join(dev, "driver")):
                    os.symlink(os.path.join(pci, "drivers", "vfio-pci"), os.path.join(dev, "driver"))
        elif path.endswith("unbind"):
            os.unlink(os.path.join(dev, "driver"))

    status = comp.StatusFiles(os.path.join(tmp, "sandbox"))
    vfio_manager._write = kernel_write
    try:
        rc = vfio_manager.bind_all(pci, status)
        info = comp.validate_vfio_pci(status, sysfs=os.path.join(pci, "devices"))
        switch = vfio_manager.current_driver("0000:fe:00.0", pci)
        if rc != 0 or info["bound"] != sorted(cards) or switch != "nvidia-nvswitch":
            raise RuntimeError(f"vfio manager: rc={rc}, bound {info}, NVSwitch on {switch!r}")
        vfio_manager.unbind_all(pci, status)
        released = {a: vfio_manager.current_driver(a, pci) for a in cards}
        if any(released.values()) or status.exists("vfio-pci-ready"):
            raise RuntimeError(f"unbind-all left {released}")
    finally:
        vfio_manager._write = write
    log(f"vfio manager (fixture tree): bound {info['bound']}, NVSwitch kept {switch!r}, foreign kept "
        f"{vfio_manager.current_driver('0000:fe:01.0', pci)!r}; vfio-pci component passed; unbind-all released")

    dev = os.path.join(tmp, "vmdev")
    os.makedirs(os.path.join(dev, "vfio"))
    for name in ["vfio"] + [str(10 + i) for i in range(len(chips))]:
        open(os.path.join(dev, "vfio", name), "w").close()
    config = os.path.join(tmp, "vm-devices.yaml")
    with open(config, "w") as f:
        json.dump({"vm-device-configs": {"default": [{"devices": "all", "passthrough": True}]}}, f)
    state_file = os.path.join(tmp, "vm-devices.json")
    if vm_manager.vm_manager_ready(dev, status) != 0:
        raise RuntimeError("vm manager refused the vfio tree")
    groups = comp.validate_vm_manager(status, dev_root=dev)["groups"]
    vm_manager.apply_vm_device_config(config, "default", dev, state_file)
    devices = comp.validate_vm_devices(status, dev_root=dev, state_file=state_file, retries=1)
    vm_manager.install_kata(os.path.join(tmp, "kata-src"), os.path.join(tmp, "kata"),
                            os.path.join(tmp, "conf.d"))
    snippets = os.listdir(os.path.join(tmp, "conf.d"))
    if len(groups) != len(chips) or devices["devices"] != len(chips) or not snippets:
        raise RuntimeError(f"vm operands: groups {groups}, devices {devices}, kata {snippets}")
    log(f"vm operands (fixture tree): vm-manager and vm-devices components passed on {len(groups)} "
        f"group(s); kata snippet {snippets}")
    log(f"MIG mode (NVML, current/pending; absent where NVML does not answer): "
        f"{ {c['index']: (c.get('mig_mode'), c.get('mig_mode_pending')) for c in chips} }")


def phase_node_operands() -> None:
    """The node's partition and telemetry operands (phase 8); raises on
    any miss."""
    from tpu_operator_torch import _build
    from tpu_operator_torch.native import gpuinfo
    from tpu_operator_torch.validator import components as comp

    t_phase = time.perf_counter()
    _build.reset_launches()
    n = torch.cuda.device_count()
    chips = gpuinfo.chip_summary()
    if len(chips) != n or any(c["source"] != "nvml" for c in chips):
        raise RuntimeError(f"the chip table does not hold torch's {n} cards from NVML: {chips}")
    with tempfile.TemporaryDirectory(prefix="cs8-") as tmp:
        for step, check in (
            ("slice manager", lambda: check_slice_manager(tmp, chips, n)),
            ("exporter", lambda: check_exporter(tmp, chips, n)),
            ("driver installer", lambda: check_driver_installer(tmp, comp)),
            ("driver manager", lambda: check_driver_manager(tmp, comp)),
            ("vfio and vm operands", lambda: check_sandbox_operands(tmp, comp, chips)),
        ):
            t0 = time.perf_counter()
            check()
            log(f"phase 8 {step}: {time.perf_counter() - t0:.2f} s")
    launched = {k: v for k, v in _build.launches.items() if v}
    if launched:
        raise RuntimeError(f"the node's operands launched kernels of the package: {launched}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"node operands on: {smi.stdout.strip() or smi.stderr.strip()}; no kernel of the package "
        f"launched; phase 8 {time.perf_counter() - t_phase:.1f} s")


# phase 9: the native programs
NATIVE_TIMEOUT_S = 30  # for a hostengine to bind, serve or merge a side file
NATIVE_REPS = 5  # table calls and GETs timed
# the chip table's fields that two reads of a card give alike; the rest
# are counters, which move between reads
IDENTITY_FIELDS = ("index", "path", "name", "uuid", "pci_address", "power_limit_mw",
                   "memory_total_bytes", "mig_mode", "mig_mode_pending", "numa_node", "vendor",
                   "pci_class", "source")
COUNTER_RANGES = {"utilization_gpu": (0, 100), "utilization_memory": (0, 100),
                  "temperature_c": (0, 125), "memory_used_bytes": (0, float("inf"))}
NVML_DRIVER_NOT_LOADED = 9


def nvml_down_stub(path: str) -> None:
    """Compile a libnvidia-ml.so.1 stand-in at ``path`` whose every entry
    answers DRIVER_NOT_LOADED: with it the native probe reads the device
    nodes, as on a node whose driver has not come up."""
    from tpu_operator_torch.native import build as native_build
    from tpu_operator_torch.native import gpuinfo

    body = "".join(
        'const char* nvmlErrorString(...) { return "Driver Not Loaded"; }\n' if name == "nvmlErrorString"
        else f"int {name}(...) {{ return {NVML_DRIVER_NOT_LOADED}; }}\n"
        for name in gpuinfo.NVML_SIGNATURES)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    subprocess.run([native_build.find_cxx(), "-shared", "-fPIC", "-x", "c++", "-o", path, "-"],
                   input=f'extern "C" {{\n{body}}}\n', text=True, check=True, timeout=120)


def _get(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def _wait_for(what: str, fn, timeout_s: float = NATIVE_TIMEOUT_S):
    """``fn()``'s first truthy value within ``timeout_s``; raises after."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            got = fn()
        except OSError:
            got = None
        if got:
            return got
        time.sleep(0.05)
    raise RuntimeError(f"no {what} within {timeout_s} s")


def check_native_table(gpuinfo, n) -> None:
    """The native table against the ctypes table: identity fields equal,
    counters present alike and in range; one call of each timed, in turns;
    the native probe against the Python probe on every card's node."""
    if not gpuinfo.native_available():
        raise RuntimeError("libgpuinfo.so did not load")
    native_lib = gpuinfo._native
    times = {"native": [], "ctypes": []}
    tables = {}
    for _ in range(NATIVE_REPS):
        for path in ("native", "ctypes"):
            gpuinfo._native = native_lib if path == "native" else None
            try:
                t0 = time.perf_counter()
                tables[path] = gpuinfo.chip_summary()
                times[path].append((time.perf_counter() - t0) * 1e3)
            finally:
                gpuinfo._native = native_lib
    native, py = tables["native"], tables["ctypes"]
    log(f"native chip table: {json.dumps(native)}")
    if len(native) != n or any(c["source"] != "nvml" for c in native):
        raise RuntimeError(f"the native table does not hold torch's {n} cards from NVML")
    if [c["index"] for c in native] != [c["index"] for c in py]:
        raise RuntimeError(f"native ids {[c['index'] for c in native]}, ctypes {[c['index'] for c in py]}")
    for a, b in zip(native, py):
        ident_a = {k: a[k] for k in IDENTITY_FIELDS if k in a}
        ident_b = {k: b[k] for k in IDENTITY_FIELDS if k in b}
        if ident_a != ident_b:
            raise RuntimeError(f"card {a['index']}: native {ident_a} against ctypes {ident_b}")
        if set(a) != set(b):
            raise RuntimeError(f"card {a['index']}: native keys {sorted(a)}, ctypes {sorted(b)}")
        for key, (lo, hi) in COUNTER_RANGES.items():
            if key in a and not (lo <= a[key] <= hi and lo <= b[key] <= hi):
                raise RuntimeError(f"card {a['index']}: {key} native {a[key]} ctypes {b[key]}")
        if a.get("memory_used_bytes", 0) > a.get("memory_total_bytes", float("inf")):
            raise RuntimeError(f"card {a['index']}: memory in use above the total")
    log(f"native table == ctypes table on {IDENTITY_FIELDS} ({n} cards); "
        f"one call, ms: native {[round(t, 3) for t in times['native']]}, "
        f"ctypes {[round(t, 3) for t in times['ctypes']]}")
    for c in native:
        rc = native_lib.gpuinfo_device_probe_path(c["path"].encode())
        py_alive = gpuinfo._py_probe_path(c["path"])
        if (rc >= 0) != py_alive or not py_alive:
            raise RuntimeError(f"{c['path']}: native probe {rc}, Python probe {py_alive}")
        log(f"device probe {c['path']}: native {rc} (0 open, 1 busy or denied), Python {py_alive}")


def check_smoke(smoke, tmp, n) -> None:
    """gpu_smoke against torch and nvidia-smi; an empty device root exits 2
    where NVML does not answer (with NVML answering, its cards stand under
    any root)."""
    smi = _smi_cards()
    proc = subprocess.run([smoke, "--json"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"gpu_smoke exited {proc.returncode}: {proc.stderr}")
    table = json.loads(proc.stdout)
    names = sorted(c.get("name", "") for c in table)
    if len(table) != n or len(smi) != n or names != sorted(name for name, _ in smi):
        raise RuntimeError(f"gpu_smoke's {names} against torch's {n} and nvidia-smi's {smi}")
    log(f"gpu_smoke --json: rc 0, {len(table)} cards {names} == nvidia-smi and torch")
    empty = os.path.join(tmp, "empty-dev")
    os.makedirs(empty)
    stub = os.path.join(tmp, "nvml-down", "libnvidia-ml.so.1")
    nvml_down_stub(stub)
    down = subprocess.run([smoke, "--dev-root", empty, "--json"], capture_output=True, text=True,
                          timeout=60, env={**os.environ, "NVML_LIBRARY": stub})
    if down.returncode != 2 or json.loads(down.stdout) != []:
        raise RuntimeError(f"gpu_smoke on an empty root without NVML: rc {down.returncode} {down.stdout}")
    up = subprocess.run([smoke, "--dev-root", empty], capture_output=True, text=True, timeout=60)
    log(f"gpu_smoke --dev-root <empty>: rc 2 [] where NVML does not answer; with NVML "
        f"rc {up.returncode}: {up.stdout.splitlines()[0] if up.stdout else up.stderr}")


def check_hostengine(gpuinfo, tmp, n) -> float:
    """``python -m tpu_operator_torch.metricsd --port 0`` execs the
    hostengine, which merges a side file the port's sampler wrote on
    cuda:0 and drops a stale one; with ``--no-native`` the Python daemon
    serves. Returns the median /json GET in ms."""
    import select
    import threading

    from tpu_operator_torch.metricsd.daemon import MetricsDaemon

    sample, drop = os.path.join(tmp, "sample.json"), os.path.join(tmp, "run", "metricsd.json")
    sampler = MetricsDaemon(own_chip=True, interval_s=3600.0)
    thread = threading.Thread(target=sampler.run_sampler, args=(sample,))
    thread.start()
    try:
        _wait_for("side file from the sampler", lambda: os.path.exists(sample), 120)
    finally:
        sampler.stop()
        thread.join(timeout=60)
    with open(sample) as f:
        side = json.load(f)
    utils = [c.get("tensorcore_util") for c in side["chips"]]
    if not all(u is not None and 0 < u <= 100 for u in utils):
        raise RuntimeError(f"the sampler's tensorcore_util out of (0, 100]: {side}")
    log(f"sampler on cuda:0 wrote {json.dumps(side)}")

    err = open(os.path.join(tmp, "metricsd.err"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_operator_torch.metricsd", "--port", "0", "--drop-file", drop,
         "--sample-file", sample, "--interval", "0.2"],
        stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        if not select.select([proc.stdout], [], [], NATIVE_TIMEOUT_S)[0]:
            raise RuntimeError("the hostengine printed no port")
        line = proc.stdout.readline()
        m = re.search(r"gpu-metricsd listening on port (\d+)", line)
        if not m:
            raise RuntimeError(f"no hostengine port line: {line!r}")
        port = int(m.group(1))
        snap = _wait_for("merged sample", lambda: (lambda d: d if d.get("sample") else None)(
            json.loads(_get(port, "/json"))))
        if snap["source"] != "gpu-metricsd-native" or snap["sample"] != side:
            raise RuntimeError(f"the hostengine did not serve the merged side file: {snap}")
        if [c["index"] for c in snap["chips"]] != [c["index"] for c in gpuinfo.chip_summary()]:
            raise RuntimeError(f"the hostengine's cards are not the chip table's: {snap['chips']}")
        text = _get(port, "/metrics")
        for c in snap["chips"]:
            for want in (f'gpu_chip_present{{chip="{c["index"]}",source="nvml"}} 1',
                         f'gpu_tensorcore_utilization_percent{{chip="{c["index"]}",source="sampler"}}'):
                if want not in text:
                    raise RuntimeError(f"/metrics lacks {want!r}:\n{text}")
        log(f"metricsd --port 0 exec'd the hostengine ({line.strip()}): /json source "
            f"{snap['source']}, {len(snap['chips'])} cards, sample merged")
        log("hostengine /metrics:\n" + "\n".join(
            "  " + ln for ln in text.splitlines() if not ln.startswith("#")))
        gets = []
        for _ in range(NATIVE_REPS):
            t0 = time.perf_counter()
            _get(port, "/json")
            gets.append((time.perf_counter() - t0) * 1e3)
        dropped = gpuinfo.native_metrics(drop)
        if dropped.get("source") != "gpu-metricsd-native" or "sample" not in dropped:
            raise RuntimeError(f"the drop file through libgpuinfo: {dropped}")
        with open(sample, "w") as f:
            json.dump({**side, "ts": time.time() - 3600}, f)
        _wait_for("sample_fresh 0", lambda: "gpu_metricsd_sample_fresh 0" in _get(port, "/metrics"))
        if "sample" in json.loads(_get(port, "/json")):
            raise RuntimeError("a stale side file stayed in /json")
        log(f"stale side file: gpu_metricsd_sample_fresh 0; /json GET ms {[round(g, 3) for g in gets]}; "
            f"drop file read through libgpuinfo")
        t0 = time.perf_counter()
        proc.terminate()
        rc = proc.wait(timeout=10)
        log(f"hostengine stopped by SIGTERM in {time.perf_counter() - t0:.3f} s, rc {rc}")
        if rc != 0:
            raise RuntimeError(f"the hostengine exited {rc} on SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()

    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_operator_torch.metricsd", "--no-native", "--port", str(port),
         "--drop-file", drop, "--sample-file", sample, "--interval", "0.2"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        served = _wait_for("the Python daemon", lambda: (lambda d: d if d.get("chips") else None)(
            json.loads(_get(port, "/json"))), 60)
        if served["source"] != "gpu-metricsd" or len(served["chips"]) != n:
            raise RuntimeError(f"--no-native did not serve from Python: {served}")
        log(f"metricsd --no-native: the Python daemon served {len(served['chips'])} cards")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return sorted(gets)[len(gets) // 2]


def check_chain() -> None:
    """run_telemetry_chain with the sampler's reading while products run on
    cuda:0: ok, tensorcore_util from the sampler, duty cycle from NVML."""
    import threading

    from tpu_operator_torch.metricsd.chain import run_telemetry_chain
    from tpu_operator_torch.metricsd.daemon import MetricsDaemon

    sample = MetricsDaemon(own_chip=True)._sample_duty_cycle()
    if not sample:
        raise RuntimeError("the sampler gave no reading")
    a = torch.randn(8192, 8192, dtype=torch.bfloat16, device="cuda:0")
    b, c = torch.randn_like(a), torch.empty_like(a)
    stop = threading.Event()

    def load():
        torch.cuda.set_device(a.device)  # a new thread has no current context
        while not stop.is_set():
            for _ in range(8):
                torch.mm(a, b, out=c)
            torch.cuda.synchronize()

    thread = threading.Thread(target=load)
    thread.start()
    try:
        time.sleep(BUSY_S)
        t0 = time.perf_counter()
        out = run_telemetry_chain(sample)
        wall = time.perf_counter() - t0
    finally:
        stop.set()
        thread.join(timeout=60)
    log(f"telemetry chain in {wall:.2f} s under torch.mm on cuda:0: {json.dumps(out)}")
    if not out["ok"]:
        raise RuntimeError(f"the telemetry chain failed: {out.get('error')}")
    if out["sources"]["tensorcore_util_percent"] != "sampler":
        raise RuntimeError("tensorcore_util did not come from the sampler")
    if not (out["duty_cycle_percent"] > 0 and out["sources"]["duty_cycle_percent"] == "nvml"):
        raise RuntimeError("the duty cycle did not read above 0 from NVML")


def phase_native() -> None:
    """The native programs on the card (phase 9); raises on any miss."""
    from tpu_operator_torch import _build
    from tpu_operator_torch.native import build as native_build
    from tpu_operator_torch.native import gpuinfo

    t_phase = time.perf_counter()
    _build.reset_launches()
    n = torch.cuda.device_count()
    info = native_build.build()
    log(f"native: {native_build.cxx_version()}; built={info['built']} in {info['seconds']:.2f} s: "
        f"{sorted(info['paths'])} in {info['dir']}")
    with tempfile.TemporaryDirectory(prefix="cs9-") as tmp:
        t0 = time.perf_counter()
        check_smoke(info["paths"][native_build.SMOKE_NAME], tmp, n)
        log(f"phase 9 smoke: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        check_native_table(gpuinfo, n)
        log(f"phase 9 chip table: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        get_ms = check_hostengine(gpuinfo, tmp, n)
        log(f"phase 9 hostengine: {time.perf_counter() - t0:.2f} s; median /json GET {get_ms:.3f} ms")
    t0 = time.perf_counter()
    check_chain()
    log(f"phase 9 chain: {time.perf_counter() - t0:.2f} s")
    launched = {k: v for k, v in _build.launches.items() if v}
    if launched:
        raise RuntimeError(f"the native programs' phase launched kernels of the package: {launched}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"native programs on: {smi.stdout.strip() or smi.stderr.strip()}; no kernel of the package "
        f"launched; phase 9 {time.perf_counter() - t_phase:.1f} s")


# phase 10: the control plane's foundation
CONTROL_PLANE_TIMEOUT_S = 300  # the phase's watchdog
FLEET_NODES = 1000  # the reference's fleet axes (bench.py:840, :861)
LIST_PAGE = 500  # client-go's pager default


def check_cfg_cli(tmp, sample_path, crdgen) -> str:
    """``gpuop-cfg generate crd`` gives the generated CRD, ``validate
    clusterpolicy`` passes the sample and fails a copy with an enum
    violated, naming the field. Returns the violated copy."""
    import yaml

    def cfg(*args):
        return subprocess.run([sys.executable, "-m", "tpu_operator_torch.cfg", *args],
                              capture_output=True, text=True, timeout=120)

    gen = cfg("generate", "crd")
    if gen.returncode != 0 or yaml.safe_load(gen.stdout) != crdgen.build_crd():
        raise RuntimeError(f"gpuop-cfg generate crd: rc={gen.returncode}\n{gen.stderr[-2000:]}")
    ok = cfg("validate", "clusterpolicy", "--input", sample_path)
    if ok.returncode != 0:
        raise RuntimeError(f"gpuop-cfg refused the sample: rc={ok.returncode}\n{ok.stderr[-2000:]}")
    with open(sample_path) as f:
        bad = yaml.safe_load(f)
    bad["spec"]["operator"]["defaultRuntime"] = "rkt"
    bad_path = os.path.join(tmp, "bad-clusterpolicy.yaml")
    with open(bad_path, "w") as f:
        yaml.safe_dump(bad, f)
    no = cfg("validate", "clusterpolicy", "--input", bad_path)
    if no.returncode != 1 or "spec.operator.defaultRuntime" not in no.stderr:
        raise RuntimeError(f"gpuop-cfg on an enum violation: rc={no.returncode}, {no.stderr[-2000:]!r}")
    log(f"gpuop-cfg: generate crd rc=0; validate sample rc=0; enum violated rc=1: {no.stderr.strip()}")
    return bad


def phase_control_plane() -> None:
    """The control plane's foundation on the card machine (phase 10): the
    chain card -> plugin -> kubelet -> API server -> validator; raises on
    any miss."""
    import queue
    import threading

    import grpc

    from tpu_operator_torch import _build
    from tpu_operator_torch import consts
    from tpu_operator_torch.api.v1 import clusterpolicy_types as cpt
    from tpu_operator_torch.cfg import crdgen, schema_validate
    from tpu_operator_torch.discovery import tfd
    from tpu_operator_torch.kube import kubelet_sim, kubesim
    from tpu_operator_torch.native import gpuinfo
    from tpu_operator_torch.plugin import server as plugin
    from tpu_operator_torch.validator import components as comp

    import yaml

    t_phase = time.perf_counter()
    _build.reset_launches()
    n = torch.cuda.device_count()
    chips = gpuinfo.chip_summary()
    uuid = {str(c["index"]): c.get("uuid") for c in chips}
    if len(chips) != n or any(c["source"] != "nvml" or not c.get("uuid") for c in chips):
        raise RuntimeError(f"the chip table does not name torch's {n} cards by UUID: {chips}")
    ids = sorted(uuid, key=int)
    sample_path = os.path.join(os.path.dirname(cpt.__file__), "sample_clusterpolicy.yaml")
    log(f"control plane: grpc {grpc.__version__}, PyYAML {yaml.__version__}")
    faulthandler.dump_traceback_later(CONTROL_PLANE_TIMEOUT_S, exit=True)
    stop = threading.Event()
    events = queue.Queue()
    with tempfile.TemporaryDirectory(prefix="cs10-") as tmp:
        # 1. gpuop-cfg
        bad = check_cfg_cli(tmp, sample_path, crdgen)
        sim_server = kubesim.KubeSimServer(port=0).start()
        kubelet = plugin_server = watcher = None
        try:
            # 2. the CRD and the sample through the RestClient; admission
            c = kubesim.make_client(sim_server.port)
            c.create(crdgen.build_crd())
            with open(sample_path) as f:
                sample = yaml.safe_load(f)
            t0 = time.perf_counter()
            stored = c.create(json.loads(json.dumps(sample)))
            admit_ms = (time.perf_counter() - t0) * 1e3
            want = json.loads(json.dumps(sample))
            schema_validate.default_cr(crdgen.build_crd(), want)
            if {k: v for k, v in stored.items() if k != "metadata"} != {k: v for k, v in want.items()
                                                                       if k != "metadata"}:
                raise RuntimeError(f"the stored ClusterPolicy is not the defaulted sample: {stored}")
            bad["metadata"]["name"] = "bad"
            try:
                c.create(bad)
                raise RuntimeError("KubeSim admitted a ClusterPolicy with an enum violated")
            except RuntimeError as e:
                if "422" not in str(e) or "defaultRuntime" not in str(e):
                    raise
            log(f"KubeSim on 127.0.0.1:{sim_server.port}: CRD registered; sample admitted in "
                f"{admit_ms:.2f} ms and stored as default_cr(sample); the enum violation answered 422")

            # 3. the card's node from feature discovery, then the fleet
            labels = tfd.gather_features({"metadata": {"name": OPERANDS_NODE, "labels": {}}},
                                         dev_root="/dev", driver_root="/", env={}, chips=chips)
            check_features(labels, n)
            labels["kubernetes.io/hostname"] = OPERANDS_NODE
            c.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": OPERANDS_NODE, "labels": labels}})
            t0 = time.perf_counter()
            fleet = sim_server.sim.add_nodes(FLEET_NODES - 1)
            join_s = time.perf_counter() - t0
            c.list_page_size = lambda: LIST_PAGE
            pages = []
            request = c._request
            c._request = lambda method, path, *a, **kw: pages.append(path) or request(method, path, *a, **kw)
            t0 = time.perf_counter()
            nodes = c.list("v1", "Node")
            list_ms = (time.perf_counter() - t0) * 1e3
            del c._request
            names = [x["metadata"]["name"] for x in nodes]
            if len(names) != FLEET_NODES or set(names) != set(fleet) | {OPERANDS_NODE}:
                raise RuntimeError(f"the paged LIST gave {len(names)} nodes ({len(set(names))} distinct)")
            t0 = time.perf_counter()
            mine = c.list("v1", "Node", label_selector=f"kubernetes.io/hostname={OPERANDS_NODE}")
            select_ms = (time.perf_counter() - t0) * 1e3
            if [x["metadata"]["name"] for x in mine] != [OPERANDS_NODE]:
                raise RuntimeError(f"the label-selector LIST gave {[x['metadata']['name'] for x in mine]}")
            log(f"fleet: {FLEET_NODES - 1} nodes of {kubesim.HOST_CARDS} cards joined in {join_s:.2f} s; "
                f"paged LIST (limit {LIST_PAGE}, {len(pages)} pages) of {len(names)} nodes, each once, in "
                f"{list_ms:.1f} ms; label-selector LIST of the card's node in {select_ms:.2f} ms")

            # 4. plugin -> kubelet -> API server, seen through a watch
            def on_event(etype, obj):
                if obj["metadata"]["name"] == OPERANDS_NODE:
                    events.put((time.perf_counter(), obj.get("status", {})))

            synced = threading.Event()
            watcher = threading.Thread(target=kubesim.make_client(sim_server.port).watch,
                                       args=("v1", "Node", on_event),
                                       kwargs={"stop_event": stop, "timeout_s": 5, "on_sync": synced.set},
                                       daemon=True)
            watcher.start()
            if not synced.wait(PLUGIN_TIMEOUT_S):
                raise RuntimeError("the watch on the nodes did not sync")

            def watched(alloc):
                deadline = time.time() + PLUGIN_TIMEOUT_S
                while time.time() < deadline:
                    try:
                        t, st = events.get(timeout=1)
                    except queue.Empty:
                        continue
                    got = (st.get("capacity", {}).get(consts.GPU_RESOURCE),
                           st.get("allocatable", {}).get(consts.GPU_RESOURCE))
                    if got == (str(n), str(alloc)):
                        return t
                raise RuntimeError(f"no watch event with capacity {n} and allocatable {alloc} "
                                   f"within {PLUGIN_TIMEOUT_S} s")

            socket_dir = os.path.join(tmp, "k")
            kubelet = kubelet_sim.KubeletDeviceManager(kubesim.make_client(sim_server.port), OPERANDS_NODE,
                                                       socket_dir)
            kubelet.start()
            servicer = plugin.GPUDevicePluginServicer(dev_root="/dev", driver_root="/", poll_interval_s=0.2,
                                                      health_probe_interval_s=3600)
            plugin_server = plugin.DevicePluginServer(servicer, socket_dir=socket_dir)
            plugin_server.start()
            t0 = time.perf_counter()
            plugin_server.register_with_kubelet(kubelet.kubelet_socket)
            capacity_ms = (watched(n) - t0) * 1e3
            log(f"kubelet: register_with_kubelet to the watched capacity {n} / allocatable {n} of "
                f"{consts.GPU_RESOURCE} in KubeSim: {capacity_ms:.1f} ms")

            # 5. the plugin component over the RestClient; Unhealthy and back
            status = comp.StatusFiles(os.path.join(tmp, "validations"))
            info = comp.validate_plugin(status, c, OPERANDS_NODE, retries=3, sleep_s=0.2)
            if (info["capacity"], info["allocatable"]) != (n, n):
                raise RuntimeError(f"plugin component over the RestClient: {info}")
            t0 = time.perf_counter()
            servicer.mark_unhealthy(ids[0])
            down_ms = (watched(n - 1) - t0) * 1e3
            t0 = time.perf_counter()
            servicer.mark_healthy(ids[0])
            up_ms = (watched(n) - t0) * 1e3
            log(f"plugin component over the RestClient: {json.dumps(info)}; card {ids[0]} Unhealthy -> "
                f"allocatable {n - 1} watched in {down_ms:.1f} ms, healthy again in {up_ms:.1f} ms")

            # 6. the kubelet's admission sequence, and what the container sees
            t0 = time.perf_counter()
            resp = kubelet.allocate(consts.GPU_RESOURCE, 1)
            alloc_ms = (time.perf_counter() - t0) * 1e3
            cresp = resp.container_responses[0]
            got = [d.name.split("=", 1)[1] for d in cresp.cdi_devices]
            if len(got) != 1 or got[0] not in uuid:
                raise RuntimeError(f"the kubelet's allocation named {[d.name for d in cresp.cdi_devices]}")
            log(f"kubelet.allocate({consts.GPU_RESOURCE}, 1): card {got} in {alloc_ms:.2f} ms")
            container_view(got, dict(cresp.envs), uuid)
        finally:
            stop.set()
            if plugin_server is not None:
                plugin_server.stop()
            if kubelet is not None:
                kubelet.stop()
            sim_server.stop()
            if watcher is not None:
                watcher.join(30)
            faulthandler.cancel_dump_traceback_later()
        if watcher is not None and watcher.is_alive():
            raise RuntimeError("the node watch outlived the phase")
    launched = {k: v for k, v in _build.launches.items() if v}
    if launched:
        raise RuntimeError(f"the control plane launched kernels of the package: {launched}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"control plane on: {smi.stdout.strip() or smi.stderr.strip()}; CR admission {admit_ms:.2f} ms, "
        f"paged LIST of {FLEET_NODES} nodes {list_ms:.1f} ms, capacity watched {capacity_ms:.1f} ms after "
        f"registration; no kernel of the package launched; phase 10 {time.perf_counter() - t_phase:.1f} s")


# phase 11: the control plane's read and write paths
READ_WRITE_TIMEOUT_S = 400  # the phase's watchdog
PIPELINE_DEPTHS = (1, 4, 16)  # the write pipeline's depths the label wave runs at
EVENT_REPEATS = 20  # times one capacity change is recorded inside the correlator's window
POOL_NODES = 9  # fleet nodes the simulated kubelet's DaemonSet selects beside the card's
POOL_LABEL = "chip-smoke.example.com/pool"
WAVE_LABEL = "chip-smoke.example.com/wave"
SYNC_TIMEOUT_S = 120  # for the informers to sync, a watch event or a write wave to land


def _labels_of(client, name: str) -> dict:
    return client.get("v1", "Node", name)["metadata"].get("labels", {}) or {}


def phase_control_plane_rw() -> None:
    """The control plane's read and write paths on the card machine
    (phase 11): the informer cache, the write pipeline, Events, the warm
    journal, the simulated fleet's kubelet and the operator's metrics over
    one KubeSim; raises on any miss."""
    import queue
    import threading

    from prometheus_client import REGISTRY

    from tpu_operator_torch import _build
    from tpu_operator_torch import consts
    from tpu_operator_torch.controllers import operator_metrics
    from tpu_operator_torch.discovery import tfd
    from tpu_operator_torch.kube import apply, cache, events, kubelet_sim, kubesim, rest, testing, warm
    from tpu_operator_torch.kube import write_pipeline
    from tpu_operator_torch.kube.write_pipeline import BatchLane, WritePipeline
    from tpu_operator_torch.native import gpuinfo
    from tpu_operator_torch.plugin import server as plugin

    t_phase = time.perf_counter()
    _build.reset_launches()
    if not operator_metrics.HAVE_PROM:
        raise RuntimeError("prometheus_client does not import: the operator's metrics would be no-ops")
    metrics = operator_metrics.OperatorMetrics()
    n = torch.cuda.device_count()
    chips = gpuinfo.chip_summary()
    uuid = {str(c["index"]): c.get("uuid") for c in chips}
    if len(chips) != n or any(c["source"] != "nvml" or not c.get("uuid") for c in chips):
        raise RuntimeError(f"the chip table does not name torch's {n} cards by UUID: {chips}")
    ids = sorted(uuid, key=int)
    ns = consts.DEFAULT_NAMESPACE
    faulthandler.dump_traceback_later(READ_WRITE_TIMEOUT_S, exit=True)
    stop = threading.Event()
    caps = queue.Queue()
    nums = {}
    with tempfile.TemporaryDirectory(prefix="cs11-") as tmp:
        sim_server = kubesim.KubeSimServer(port=0).start()
        sim = sim_server.sim
        caches = []
        kubelet = plugin_server = None
        window = events.EVENT_REFRESH_INTERVAL_S
        try:
            # 1. the port's CRD and sample, the card's node from feature
            # discovery, then the fleet
            raw = kubesim.make_client(sim_server.port)
            testing.seed_cluster(raw, ns, node_names=())
            labels = tfd.gather_features({"metadata": {"name": OPERANDS_NODE, "labels": {}}},
                                         dev_root="/dev", driver_root="/", env={}, chips=chips)
            check_features(labels, n)
            labels["kubernetes.io/hostname"] = OPERANDS_NODE
            raw.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": OPERANDS_NODE, "labels": labels}})
            fleet = sim.add_nodes(FLEET_NODES - 1)
            all_nodes = [OPERANDS_NODE] + fleet

            # 2. the informers' sync; then reads that issue no request
            cached = cache.CachedClient(kubesim.make_client(sim_server.port), namespace=ns, resync_interval_s=0)
            caches.append(cached)
            synced_at = {}
            for (_, kind), inf in cached._informers.items():
                inf.synced.set = lambda done=inf.synced.set, kind=kind: (
                    synced_at.setdefault(kind, time.perf_counter()), done())
            t0 = time.perf_counter()
            if not cached.start_informers(stop, timeout_s=SYNC_TIMEOUT_S):
                raise RuntimeError("the informers did not sync")
            nums["cold_sync_ms"] = (time.perf_counter() - t0) * 1e3
            by_kind = {k: round((t - t0) * 1e3, 2) for k, t in sorted(synced_at.items(), key=lambda kv: kv[1])}
            if len(by_kind) != len(cached._informers):
                raise RuntimeError(f"informers synced: {sorted(by_kind)} of {len(cached._informers)}")
            requests = []
            request = cached.live._request
            cached.live._request = lambda method, path, *a, **kw: requests.append((method, path)) or request(
                method, path, *a, **kw)
            t0 = time.perf_counter()
            node = cached.get("v1", "Node", OPERANDS_NODE)
            mine = cached.list("v1", "Node", label_selector={"kubernetes.io/hostname": OPERANDS_NODE})
            nodes = cached.list("v1", "Node")
            read_ms = (time.perf_counter() - t0) * 1e3
            if requests or [x["metadata"]["name"] for x in mine] != [OPERANDS_NODE] or len(nodes) != FLEET_NODES:
                raise RuntimeError(f"cached reads: {len(requests)} requests, selector gave "
                                   f"{[x['metadata']['name'] for x in mine]}, {len(nodes)} nodes")
            if node["metadata"]["labels"] != labels:
                raise RuntimeError("the cached node's labels are not feature discovery's")
            seen = threading.Event()
            cached.add_event_hook(lambda etype, obj: seen.set() if obj.get("kind") == "Node" and (
                obj["metadata"].get("labels") or {}).get("chip-smoke.example.com/foreign") == "1" else None)
            t0 = time.perf_counter()
            kubesim.make_client(sim_server.port).patch_labels("v1", "Node", fleet[0],
                                                              labels={"chip-smoke.example.com/foreign": "1"})
            if not seen.wait(SYNC_TIMEOUT_S):
                raise RuntimeError("a foreign write did not reach the cache through its watch")
            foreign_ms = (time.perf_counter() - t0) * 1e3
            if _labels_of(cached, fleet[0]).get("chip-smoke.example.com/foreign") != "1" or requests:
                raise RuntimeError(f"the foreign write is not in the store ({len(requests)} requests)")
            log(f"informer cache: {len(by_kind)} kinds synced in {nums['cold_sync_ms']:.1f} ms "
                f"(ms by kind: {json.dumps(by_kind)}); get + selector LIST + LIST of {FLEET_NODES} nodes "
                f"from the store in {read_ms:.2f} ms with 0 requests; a foreign write reached the cache's "
                f"event hook in {foreign_ms:.1f} ms")

            # 3. the card's capacity through the cache's event hook
            cached.add_event_hook(lambda etype, obj: caps.put((time.perf_counter(), obj.get("status", {})))
                                  if obj.get("kind") == "Node" and obj["metadata"]["name"] == OPERANDS_NODE else None)

            def through_cache(alloc):
                deadline = time.time() + PLUGIN_TIMEOUT_S
                while time.time() < deadline:
                    try:
                        t, st = caps.get(timeout=1)
                    except queue.Empty:
                        continue
                    got = (st.get("capacity", {}).get(consts.GPU_RESOURCE),
                           st.get("allocatable", {}).get(consts.GPU_RESOURCE))
                    if got == (str(n), str(alloc)):
                        stored = cached.get("v1", "Node", OPERANDS_NODE)["status"]
                        if stored["allocatable"].get(consts.GPU_RESOURCE) != str(alloc):
                            raise RuntimeError(f"the hook saw allocatable {alloc}, the store holds {stored}")
                        return t
                raise RuntimeError(f"no cache event with capacity {n} and allocatable {alloc} "
                                   f"within {PLUGIN_TIMEOUT_S} s")

            socket_dir = os.path.join(tmp, "k")
            kubelet = kubelet_sim.KubeletDeviceManager(kubesim.make_client(sim_server.port), OPERANDS_NODE, socket_dir)
            kubelet.start()
            servicer = plugin.GPUDevicePluginServicer(dev_root="/dev", driver_root="/", poll_interval_s=0.2,
                                                      health_probe_interval_s=3600)
            plugin_server = plugin.DevicePluginServer(servicer, socket_dir=socket_dir)
            plugin_server.start()
            t0 = time.perf_counter()
            plugin_server.register_with_kubelet(kubelet.kubelet_socket)
            nums["capacity_ms"] = (through_cache(n) - t0) * 1e3
            t0 = time.perf_counter()
            servicer.mark_unhealthy(ids[0])
            down_ms = (through_cache(n - 1) - t0) * 1e3
            t0 = time.perf_counter()
            servicer.mark_healthy(ids[0])
            up_ms = (through_cache(n) - t0) * 1e3
            log(f"capacity through the cache's event hook: {n} / {n} of {consts.GPU_RESOURCE} "
                f"{nums['capacity_ms']:.1f} ms after registration; card {ids[0]} Unhealthy -> allocatable {n - 1} "
                f"in {down_ms:.1f} ms, healthy again in {up_ms:.1f} ms")

            # 4. Events: one capacity change recorded again and again
            policy = events.cluster_policy_ref()
            message = f"{consts.GPU_RESOURCE}: capacity {n}, allocatable {n}"

            def stored(reason):
                return [e for e in kubesim.make_client(sim_server.port).list("v1", "Event", ns)
                        if e["reason"] == reason]

            events.reset_correlator(cached)
            events.EVENT_REFRESH_INTERVAL_S = 3600.0
            events.record_event(cached, ns, policy, events.TYPE_NORMAL, "CapacityChanged", message)
            before = len(requests)
            t0 = time.perf_counter()
            for _ in range(EVENT_REPEATS - 1):
                events.record_event(cached, ns, policy, events.TYPE_NORMAL, "CapacityChanged", message)
            coalesce_us = (time.perf_counter() - t0) * 1e6 / (EVENT_REPEATS - 1)
            coalesced_requests = len(requests) - before
            inside = stored("CapacityChanged")
            events.EVENT_REFRESH_INTERVAL_S = 0.0
            events.record_event(cached, ns, policy, events.TYPE_NORMAL, "CapacityChanged", message)
            past = stored("CapacityChanged")
            events.record_event(cached, ns, policy, events.TYPE_WARNING, "CardUnhealthy", f"card {ids[0]}",
                                dedup_extra=ids[0])
            events.record_event(cached, ns, policy, events.TYPE_WARNING, "CardUnhealthy", f"card {ids[-1]}x",
                                dedup_extra=ids[-1] + "x")
            apart = stored("CardUnhealthy")
            if (coalesced_requests or [e["count"] for e in inside] != [1]
                    or [e["count"] for e in past] != [EVENT_REPEATS + 1]
                    or sorted(e["message"] for e in apart) != sorted([f"card {ids[0]}", f"card {ids[-1]}x"])
                    or past[0]["source"] != {"component": consts.EVENT_COMPONENT}):
                raise RuntimeError(f"Events: {coalesced_requests} requests for coalesced records; inside the "
                                   f"window {inside}, past it {past}, apart {apart}")
            log(f"events: {EVENT_REPEATS} records of one capacity change on the ClusterPolicy -> one Event, "
                f"count {past[0]['count']} once past the window; {EVENT_REPEATS - 1} coalesced records issued "
                f"0 requests ({coalesce_us:.1f} us each); two dedup_extra records stored apart")

            # 5. the write pipeline: one label on every node, at each depth
            walls = {}
            for depth in PIPELINE_DEPTHS:
                value = f"depth-{depth}"
                pipe = WritePipeline(depth=depth, name=f"cs11-d{depth}")
                t0 = time.perf_counter()
                for name in all_nodes:
                    pipe.submit(("Node", "", name), cached.patch_labels, "v1", "Node", name,
                                labels={WAVE_LABEL: value})
                for rev in ("1", "2"):  # two revisions under one key
                    pipe.submit(("Node", "", OPERANDS_NODE), cached.patch_labels, "v1", "Node", OPERANDS_NODE,
                                labels={WAVE_LABEL: value + "-rev" + rev})
                errors = pipe.drain(timeout=SYNC_TIMEOUT_S)
                walls[depth] = (time.perf_counter() - t0) * 1e3
                if errors:
                    raise RuntimeError(f"depth {depth}: {len(errors)} writes failed: {errors[:3]}")
                want = {name: value for name in fleet}
                want[OPERANDS_NODE] = value + "-rev2"
                _wait_for(f"depth {depth}'s wave in the cache",
                          lambda: all(_labels_of(cached, k).get(WAVE_LABEL) == v for k, v in want.items()),
                          SYNC_TIMEOUT_S)
            lane_pipe = WritePipeline(depth=4, name="cs11-lane")
            lane = BatchLane(lane_pipe, lambda payloads: apply.batch_flush(
                cached, payloads, field_manager="chip-smoke", force=True, prune=False, update_only=True),
                name="cs11-nodes", shards=4)

            def node_apply(name, value):
                return {"apiVersion": "v1", "kind": "Node", "metadata": {"name": name, "labels": {WAVE_LABEL: value}}}

            t0 = time.perf_counter()
            futs = [lane.submit(("Node", "", name), node_apply(name, "lane")) for name in all_nodes]
            futs += [lane.submit(("Node", "", OPERANDS_NODE), node_apply(OPERANDS_NODE, "lane-rev" + rev))
                     for rev in ("1", "2")]
            errors = lane_pipe.drain(timeout=SYNC_TIMEOUT_S)
            for f in futs:
                f.result(timeout=SYNC_TIMEOUT_S)
            walls["lane"] = (time.perf_counter() - t0) * 1e3
            want = {name: "lane" for name in fleet}
            want[OPERANDS_NODE] = "lane-rev2"
            _wait_for("the batch lane's wave in the cache",
                      lambda: all(_labels_of(cached, k).get(WAVE_LABEL) == v for k, v in want.items()),
                      SYNC_TIMEOUT_S)
            stats = lane.stats()
            if errors or stats["items_failed_total"]:
                raise RuntimeError(f"the batch lane: {errors}, {stats}")
            nums["pipeline_ms"] = walls
            log(f"write pipeline: {len(all_nodes)} label patches (+2 revisions of one key, landed in order) "
                f"at depth " + ", ".join(f"{d}: {walls[d]:.1f} ms" for d in PIPELINE_DEPTHS)
                + f"; batch lane (depth 4, 4 shards): {walls['lane']:.1f} ms in {stats['batches_total']} "
                f"batches (max fill {stats['max_fill']}); every node carries the last value in the cache")

            # 6. the warm journal: save, stop, change a node, warm-start
            journal = warm.WarmJournal(os.path.join(tmp, "warm.json"))
            if not journal.save(warm.export_state(cached, None, ns)):
                raise RuntimeError("the warm journal was not saved")
            cached.stop(timeout_s=30)
            if cached._threads:
                raise RuntimeError(f"the cache's threads outlived stop: {cached._threads}")
            raw.patch_labels("v1", "Node", fleet[1], labels={"chip-smoke.example.com/while-down": "1"})
            payload = journal.load(ns)
            if payload is None:
                raise RuntimeError("the warm journal did not load")
            warm_cache = cache.CachedClient(kubesim.make_client(sim_server.port), namespace=ns, resync_interval_s=0)
            caches.append(warm_cache)
            seeded = warm.seed_state(warm_cache, None, payload)["informer_kinds"]
            lists = sim.request_counts.get("LIST", 0)
            t0 = time.perf_counter()
            if not warm_cache.start_informers(stop, timeout_s=SYNC_TIMEOUT_S):
                raise RuntimeError("the warm cache did not sync")
            nums["warm_start_ms"] = (time.perf_counter() - t0) * 1e3
            listed = sim.request_counts.get("LIST", 0) - lists
            caught_up_ms = (_wait_for("the change made while the cache was down", lambda: _labels_of(
                warm_cache, fleet[1]).get("chip-smoke.example.com/while-down") == "1" and time.perf_counter(),
                SYNC_TIMEOUT_S) - t0) * 1e3
            if listed or seeded != len(warm_cache._informers) or len(warm_cache.list("v1", "Node")) != FLEET_NODES:
                raise RuntimeError(f"warm start: {listed} LISTs, {seeded} kinds seeded of "
                                   f"{len(warm_cache._informers)}")
            log(f"warm journal: {journal.last_save_bytes} bytes; {seeded} kinds seeded; warm start "
                f"{nums['warm_start_ms']:.1f} ms with 0 LISTs against a cold sync of {nums['cold_sync_ms']:.1f} ms; "
                f"the node changed while down seen {caught_up_ms:.1f} ms after the start")

            # 7. the simulated fleet's kubelet over one OnDelete DaemonSet
            pool = [OPERANDS_NODE] + fleet[:POOL_NODES]
            for name in pool:
                raw.patch_labels("v1", "Node", name, labels={POOL_LABEL: "a"})
            app, version = consts.DRIVER_APP, labels[consts.DRIVER_VERSION_LABEL]
            raw.create({"apiVersion": "apps/v1", "kind": "DaemonSet", "metadata": {"name": app, "namespace": ns},
                        "spec": {"selector": {"matchLabels": {"app": app}}, "updateStrategy": {"type": "OnDelete"},
                                 "template": {"metadata": {"labels": {"app": app}, "annotations": {
                                     consts.LAST_APPLIED_HASH_ANNOTATION: "h1"}},
                                     "spec": {"nodeSelector": {POOL_LABEL: "a"}, "containers": [
                                         {"name": "driver", "image": f"nvcr.io/nvidia/driver:{version}"}]}}}})

            def driver_pods():
                return sorted(((p["metadata"]["name"], p["spec"]["nodeName"], p["status"]["phase"],
                                p["metadata"]["annotations"][consts.LAST_APPLIED_HASH_ANNOTATION])
                               for p in raw.list("v1", "Pod", ns, label_selector={"app": app})))

            t0 = time.perf_counter()
            testing.simulate_kubelet_nodes(raw, ns, all_nodes)
            sweep_ms = (time.perf_counter() - t0) * 1e3
            want = sorted((f"{app}-{name}", name, "Running", "h1") for name in pool)
            got = driver_pods()
            scheduled = raw.get("apps/v1", "DaemonSet", app, ns)["status"]["desiredNumberScheduled"]
            ds = raw.get("apps/v1", "DaemonSet", app, ns)
            ds["spec"]["template"]["metadata"]["annotations"][consts.LAST_APPLIED_HASH_ANNOTATION] = "h2"
            raw.update(ds)
            testing.simulate_kubelet_nodes(raw, ns, all_nodes)
            card = raw.get("v1", "Node", OPERANDS_NODE)["metadata"]
            tflops, gbps = testing.perf_base(card["labels"])
            perf = json.loads(card["annotations"].get(consts.VALIDATOR_PERF_ANNOTATION, "{}"))
            if got != want or scheduled != len(pool) or driver_pods() != want:
                raise RuntimeError(f"the simulated kubelet: {got} (scheduled {scheduled}), after the template "
                                   f"change {driver_pods()}; want {want}")
            if perf != {"gbps": gbps, "tflops": tflops, "version": version} or card["labels"].get(
                    consts.DRIVER_VERSION_LABEL) != version:
                raise RuntimeError(f"the node agents wrote {perf} and version "
                                   f"{card['labels'].get(consts.DRIVER_VERSION_LABEL)}")
            log(f"simulated kubelet: {app} OnDelete -> {len(pool)} Running pods at the template hash on the "
                f"nodes its nodeSelector names ({sweep_ms:.1f} ms for {len(all_nodes)} nodes); a template change "
                f"left them alone; validator-perf on the card's node {json.dumps(perf)}")

            # 8. the operator's metrics
            waits = REGISTRY.get_sample_value("gpu_operator_write_pipeline_queue_wait_duration_ms_count") or 0
            rtt = {verb: REGISTRY.get_sample_value("gpu_operator_apiserver_write_rtt_ms_count", {"verb": verb}) or 0
                   for verb in ("POST", "PUT", "PATCH", "APPLY")}
            hooked = (write_pipeline.on_queue_wait_ms == metrics.write_pipeline_queue_wait_hist.observe
                      and rest.on_write_rtt_ms == metrics._observe_write_rtt)
            if waits <= 0 or min(rtt.values()) <= 0 or not hooked:
                raise RuntimeError(f"metrics: queue-wait count {waits}, write RTT counts {rtt}, hooks {hooked}")
            mean = {verb: REGISTRY.get_sample_value("gpu_operator_apiserver_write_rtt_ms_sum", {"verb": verb}) / c
                    for verb, c in rtt.items()}
            log(f"operator metrics: gpu_operator_write_pipeline_queue_wait_duration_ms count {waits:.0f}; "
                f"gpu_operator_apiserver_write_rtt_ms count {json.dumps(rtt)}, mean ms "
                f"{json.dumps({k: round(v, 3) for k, v in mean.items()})}")
        finally:
            stop.set()
            events.EVENT_REFRESH_INTERVAL_S = window
            if plugin_server is not None:
                plugin_server.stop()
            if kubelet is not None:
                kubelet.stop()
            for c in caches:
                c.stop(timeout_s=30)
            sim_server.stop()
            faulthandler.cancel_dump_traceback_later()
        leftover = [t.name for c in caches for t in c._threads]
        if leftover:
            raise RuntimeError(f"cache threads outlived the phase: {leftover}")
    launched = {k: v for k, v in _build.launches.items() if v}
    if launched:
        raise RuntimeError(f"the control plane's read and write paths launched kernels of the package: {launched}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"read and write paths on: {smi.stdout.strip() or smi.stderr.strip()}; {json.dumps(nums)}; "
        f"no kernel of the package launched; phase 11 {time.perf_counter() - t_phase:.1f} s")


# phase 12: the state machine on the card's node
STATE_MACHINE_TIMEOUT_S = 600  # the phase's watchdog
OTHER_VARIANT_NODES = 200  # fleet nodes of the other H100 variant
CPU_NODES = 100  # fleet nodes without a card
MAX_PASSES = 6  # reconcile passes the enabled states get to read READY
PINNED_VERSION = "550.90.07"  # spec.driver.generationConfigs' version for the other variant
EDITED_VERSION = "550.127.05"  # the spec.driver.version edit
SANDBOX_APPS = ("gpu-vm-manager-daemonset", "gpu-vm-device-manager", "gpu-sandbox-validator",
                "gpu-vfio-manager-daemonset", "gpu-sandbox-device-plugin-daemonset", "gpu-kata-manager-daemonset")


def _versions(client, av: str, kind: str, ns: str = "") -> dict:
    return {o["metadata"]["name"]: o["metadata"].get("resourceVersion") for o in client.list(av, kind, ns)}


def _cache_caught_up(cached, raw, ns: str) -> bool:
    """Whether the cache holds every DaemonSet, pod, node and ClusterPolicy
    at the server's resourceVersion."""
    from tpu_operator_torch import consts

    return all(_versions(cached, av, kind, n) == _versions(raw, av, kind, n) for av, kind, n in (
        ("apps/v1", "DaemonSet", ns), ("v1", "Pod", ns), ("v1", "Node", ""),
        (consts.API_VERSION, consts.CLUSTER_POLICY_KIND, "")))


def _driver_tag(raw, name: str, ns: str) -> str:
    ds = raw.get("apps/v1", "DaemonSet", name, ns)
    return [c for c in ds["spec"]["template"]["spec"]["containers"] if c["name"] == "driver-ctr"][0]["image"].rsplit(
        ":", 1)[1]


def _stop_controller(cached, stop, ctl, raw, namespace_env) -> None:
    """Stop what a controller phase started (the cache's informers, the
    controller's pools, the simulated kubelet's pipeline) and restore the
    operator namespace; raise if a cache thread outlives it."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.kube import testing

    stop.set()
    cached.stop(timeout_s=30)
    if ctl is not None:
        for ex in (ctl._state_pool, ctl.writes._executor):
            if ex is not None:
                ex.shutdown(wait=True)
    pipe = testing._kubelet_pipelines.get(raw)
    if pipe is not None and pipe._executor is not None:
        pipe._executor.shutdown(wait=True)
    if namespace_env is None:
        os.environ.pop(consts.OPERATOR_NAMESPACE_ENV, None)
    else:
        os.environ[consts.OPERATOR_NAMESPACE_ENV] = namespace_env
    if cached._threads:
        raise RuntimeError(f"cache threads outlived the phase: {[t.name for t in cached._threads]}")


def card_device_plugin(port: int, tmp: str, chips: list) -> tuple:
    """The device plugin over the real cards, registered with a simulated
    kubelet that writes the card's node on the KubeSim at ``port``.
    Returns ``(kubelet, plugin_server, capacity)``; the caller stops the
    first two. ``capacity(alloc)`` marks cards healthy so that
    ``alloc`` of them stay allocatable (``None``: every card; 0: none) and
    waits for the node to advertise it."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.kube import kubelet_sim, kubesim
    from tpu_operator_torch.plugin import server as plugin

    n = len(chips)
    raw = kubesim.make_client(port)
    socket_dir = os.path.join(tmp, "k")
    kubelet = kubelet_sim.KubeletDeviceManager(kubesim.make_client(port), OPERANDS_NODE, socket_dir)
    kubelet.start()
    servicer = plugin.GPUDevicePluginServicer(dev_root="/dev", driver_root="/", poll_interval_s=0.2,
                                              health_probe_interval_s=3600)
    plugin_server = plugin.DevicePluginServer(servicer, socket_dir=socket_dir)
    try:
        plugin_server.start()
        plugin_server.register_with_kubelet(kubelet.kubelet_socket)
    except BaseException:
        plugin_server.stop()
        kubelet.stop()
        raise
    ids = sorted((str(c["index"]) for c in chips), key=int)

    def capacity(alloc):
        want = n if alloc is None else alloc
        for j, i in enumerate(ids):
            (servicer.mark_healthy if j >= n - want else servicer.mark_unhealthy)(i)
        _wait_for(f"allocatable {want} on the card's node", lambda: raw.get("v1", "Node", OPERANDS_NODE).get(
            "status", {}).get("allocatable", {}).get(consts.GPU_RESOURCE) == str(want), PLUGIN_TIMEOUT_S)
        return want

    return kubelet, plugin_server, capacity


def run_state_machine(port: int, ns: str, card: str, card_variant: str, other_variant: str, nodes: list,
                      cpu_nodes: list, capacity) -> dict:
    """Drive the port's ``ClusterPolicyController`` over a ``CachedClient``
    on one KubeSim (seeded with the port's CRD and sample, the card's node
    and the fleet ``nodes``) through init, convergence, a steady pass,
    three CR edits, the validator's DaemonSet lookups and the card's slice;
    ``capacity(alloc)`` makes the card's node advertise ``alloc``
    allocatable cards. Raises on any miss; returns the times."""
    import threading

    from tpu_operator_torch import consts
    from tpu_operator_torch.api.v1.clusterpolicy_types import State
    from tpu_operator_torch.controllers import slice_status, state_manager
    from tpu_operator_torch.kube import cache, kubesim, testing
    from tpu_operator_torch.kube.frozen import thaw
    from tpu_operator_torch.validator import workload_pods as wp

    raw = kubesim.make_client(port)
    nums = {}
    stop = threading.Event()
    cached = cache.CachedClient(kubesim.make_client(port), namespace=ns, resync_interval_s=0)
    request = cached.live._request
    ctl = None
    namespace_env = os.environ.get(consts.OPERATOR_NAMESPACE_ENV)
    os.environ[consts.OPERATOR_NAMESPACE_ENV] = ns
    try:
        testing.edit_clusterpolicy(raw, lambda cp: cp["spec"]["driver"].__setitem__(
            "generationConfigs", {other_variant: PINNED_VERSION}))
        if not cached.start_informers(stop, timeout_s=SYNC_TIMEOUT_S):
            raise RuntimeError("the informers did not sync")
        ctl = state_manager.ClusterPolicyController(cached)
        assets = (state_manager.DEFAULT_ASSETS_DIR if os.path.isdir(state_manager.DEFAULT_ASSETS_DIR)
                  else state_manager.PACKAGE_ASSETS_DIR)
        if ctl.assets_dir != assets:
            raise RuntimeError(f"assets from {ctl.assets_dir}, not {assets}")
        label_ms = []
        scan = ctl.label_tpu_nodes

        def timed_scan():
            t0 = time.perf_counter()
            scan()
            label_ms.append((time.perf_counter() - t0) * 1e3)

        ctl.label_tpu_nodes = timed_scan

        def cr():
            return thaw(cached.get(consts.API_VERSION, consts.CLUSTER_POLICY_KIND, "cluster-policy"))

        def one_pass():
            ctl.begin_pass()
            try:
                ctl.init(cr())
                return ctl.run_states()
            finally:
                ctl.end_pass()

        def synced():
            _wait_for("the cache to catch up with the server", lambda: _cache_caught_up(cached, raw, ns),
                      SYNC_TIMEOUT_S)

        # 2. init through the cache: the node labels
        t_ready = time.perf_counter()
        ctl.begin_pass()
        try:
            ctl.init(cr())
            nums["init_ms"] = (time.perf_counter() - t_ready) * 1e3
            nums["label_fanout_ms"] = label_ms[0]
            stored = {n["metadata"]["name"]: n["metadata"].get("labels") or {} for n in raw.list("v1", "Node")}
            want = {consts.TPU_PRESENT_LABEL: "true", consts.GENERATION_LABEL: card_variant,
                    **{consts.DEPLOY_LABEL_PREFIX + c: "true" for c in consts.CONTAINER_WORKLOAD_COMPONENTS}}
            missing = {k: stored[card].get(k) for k, v in want.items() if stored[card].get(k) != v}
            labelled_cpu = [n for n in cpu_nodes if any(
                k in (consts.TPU_PRESENT_LABEL, consts.GENERATION_LABEL) or k.startswith(consts.DEPLOY_LABEL_PREFIX)
                for k in stored[n])]
            if (missing or labelled_cpu or ctl.tpu_generations != {card_variant, other_variant}
                    or ctl.tpu_node_count != len(nodes) - len(cpu_nodes)):
                raise RuntimeError(f"init: the card's node lacks {missing}; CPU nodes labelled {labelled_cpu[:5]}; "
                                   f"variants {ctl.tpu_generations}, {ctl.tpu_node_count} GPU nodes")
            results = ctl.run_states()
        finally:
            ctl.end_pass()
        log(f"state machine init through the cache: {nums['init_ms']:.1f} ms, of it the label fan-out over "
            f"{len(nodes)} nodes {nums['label_fanout_ms']:.1f} ms; the card's node is {card_variant}; "
            f"{len(cpu_nodes)} CPU nodes unlabelled; assets {ctl.assets_dir}")

        # 3. converge: the simulated kubelets between passes
        passes = 1
        while True:
            errors = {s: repr(o) for s, o in results if isinstance(o, Exception)}
            waiting = [s for s, o in results if ctl.is_state_enabled(s) and o != State.READY]
            if errors:
                raise RuntimeError(f"pass {passes}: states raised {errors}")
            if not waiting:
                break
            if passes >= MAX_PASSES:
                raise RuntimeError(f"{passes} passes and {waiting} are not READY")
            testing.simulate_kubelet_nodes(raw, ns, nodes)
            synced()
            results = one_pass()
            passes += 1
        nums["ready_ms"], nums["passes"] = (time.perf_counter() - t_ready) * 1e3, passes
        names = sorted(_versions(raw, "apps/v1", "DaemonSet", ns))
        drivers = {f"{consts.DRIVER_APP}-{v}" for v in (card_variant, other_variant)}
        unnamed = [n for n in names if n not in set(consts.OPERAND_APPS.values()) | drivers]
        disabled = [s for s in state_manager.SANDBOX_STATES if ctl.is_state_enabled(s)]
        if (unnamed or not drivers <= set(names) or consts.DRIVER_APP in names or consts.VALIDATOR_APP not in names
                or disabled or set(SANDBOX_APPS) & set(names)):
            raise RuntimeError(f"DaemonSets {names}: not OPERAND_APPS {unnamed}, sandbox states enabled {disabled}")
        log(f"converged: every enabled state READY after {passes} passes in {nums['ready_ms']:.1f} ms; "
            f"{len(names)} DaemonSets {names}")

        # 4. the steady state: no write, every control from the render cache
        testing.simulate_kubelet_nodes(raw, ns, nodes)
        synced()
        requests = []
        cached.live._request = lambda method, path, *a, **kw: requests.append((method, path)) or request(
            method, path, *a, **kw)
        t0 = time.perf_counter()
        results = one_pass()
        nums["steady_ms"] = (time.perf_counter() - t0) * 1e3
        cached.live._request = request
        writes = [r for r in requests if r[0] != "GET"]
        hits = ctl.render_cache.stats()["last_pass"]
        waiting = [s for s, o in results if ctl.is_state_enabled(s) and o != State.READY]
        if writes or hits["misses"] or hits["hit_rate"] != 1.0 or waiting:
            raise RuntimeError(f"steady pass: writes {writes[:5]}, render cache {hits}, not READY {waiting}")
        log(f"steady pass: {nums['steady_ms']:.1f} ms, {len(requests)} requests of which 0 writes, "
            f"{hits['hits']} controls from the render cache")

        # 5. edits: an operand off, a driver version, a rollback
        exporter = consts.OPERAND_APPS["tpu-metrics-exporter"]
        testing.edit_clusterpolicy(raw, lambda cp: cp["spec"]["metricsExporter"].__setitem__("enabled", False))
        synced()
        one_pass()
        if raw.get_or_none("apps/v1", "DaemonSet", exporter, ns) is not None:
            raise RuntimeError(f"{exporter} outlived its operand's disable")
        mine = f"{consts.DRIVER_APP}-{card_variant}"
        old = _driver_tag(raw, mine, ns)
        before = {d["metadata"]["name"]: d["metadata"]["annotations"][consts.LAST_APPLIED_HASH_ANNOTATION]
                  for d in raw.list("apps/v1", "DaemonSet", ns)}
        testing.edit_clusterpolicy(raw, lambda cp: cp["spec"]["driver"].__setitem__("version", EDITED_VERSION))
        synced()
        one_pass()
        after = {d["metadata"]["name"]: d["metadata"]["annotations"][consts.LAST_APPLIED_HASH_ANNOTATION]
                 for d in raw.list("apps/v1", "DaemonSet", ns)}
        changed = sorted(n for n in after if before.get(n) != after[n])
        pinned = _driver_tag(raw, f"{consts.DRIVER_APP}-{other_variant}", ns)
        if changed != [mine] or _driver_tag(raw, mine, ns) != EDITED_VERSION or pinned != PINNED_VERSION:
            raise RuntimeError(f"driver version edit changed {changed}; {mine} at {_driver_tag(raw, mine, ns)}, "
                               f"the other variant at {pinned}")
        record = json.dumps({"kind": "driver", "target": EDITED_VERSION, "previous": old, "state": "rolled-back"})
        testing.edit_clusterpolicy(raw, lambda cp: cp["metadata"].setdefault("annotations", {}).__setitem__(
            consts.ROLLOUT_STATE_ANNOTATION, record))
        synced()
        one_pass()
        if (ctl.cp.spec.driver.version, ctl.raw_roll_targets["driver"], _driver_tag(raw, mine, ns)) != (
                old, EDITED_VERSION, old):
            raise RuntimeError(f"rollback: effective {ctl.cp.spec.driver.version}, raw {ctl.raw_roll_targets}, "
                               f"{mine} at {_driver_tag(raw, mine, ns)}")
        log(f"edits: {exporter} deleted when disabled; spec.driver.version {old} -> {EDITED_VERSION} moved only "
            f"{changed}'s hash (the other variant pinned at {pinned}); rolled back, the effective version is {old}")

        # 6. the validator's DaemonSet by the port's name
        ds = raw.get("apps/v1", "DaemonSet", consts.VALIDATOR_APP, ns)["metadata"]
        epoch = wp.gang_epoch(raw, ns)
        pod = wp.cuda_workload_pod(card, ns)
        wp.set_owner_daemonset(raw, pod, ns, consts.VALIDATOR_APP)
        raw.create(pod)
        owners = [(o["kind"], o["name"], o["uid"]) for o in
                  raw.get("v1", "Pod", pod["metadata"]["name"], ns)["metadata"].get("ownerReferences", [])]
        raw.delete("v1", "Pod", pod["metadata"]["name"], ns)
        if not ds.get("uid") or epoch != f"{ds['uid'][:8]}-{ds.get('generation', 0)}" or owners != [
                ("DaemonSet", consts.VALIDATOR_APP, ds["uid"])]:
            raise RuntimeError(f"gang epoch {epoch!r} and owners {owners} for {consts.VALIDATOR_APP} {ds}")
        log(f"{consts.VALIDATOR_APP}: gang epoch {epoch}; a workload pod owned by it")

        # 7. the card's slice: READY with its cards, NOT_READY without
        verdicts = []
        for alloc in (None, 0):
            capacity(alloc)
            summary = slice_status.aggregate(raw, ns, [raw.get("v1", "Node", card)])
            verdicts.append((summary.ready, summary.total,
                             raw.get("v1", "Node", card)["metadata"]["labels"].get(consts.SLICE_READY_LABEL)))
        degraded = [e["message"] for e in raw.list("v1", "Event", ns) if e.get("reason") == "SliceDegraded"]
        if verdicts != [(1, 1, "true"), (0, 1, "false")] or not any(card in m for m in degraded):
            raise RuntimeError(f"slice verdicts {verdicts}, SliceDegraded events {degraded}")
        log(f"slice of the card's node: READY with its cards, NOT_READY once every card is unhealthy "
            f"({degraded[0]})")
        return nums
    finally:
        cached.live._request = request
        _stop_controller(cached, stop, ctl, raw, namespace_env)


def phase_state_machine() -> None:
    """The state machine on the card's node (phase 12): the card's node from
    feature discovery and the chip table joins a fleet of both H100
    variants and CPU nodes on one KubeSim; ``run_state_machine`` drives the
    port's ``ClusterPolicyController`` through the cache; the device plugin
    over the real cards advertises the capacity the slice check reads."""
    from tpu_operator_torch import _build
    from tpu_operator_torch import consts
    from tpu_operator_torch.discovery import tfd
    from tpu_operator_torch.kube import kubesim, testing
    from tpu_operator_torch.native import gpuinfo
    from tpu_operator_torch.workloads.topology import device_generation

    t_phase = time.perf_counter()
    _build.reset_launches()
    n = torch.cuda.device_count()
    chips = gpuinfo.chip_summary()
    card_variant = device_generation(torch.cuda.get_device_name(0))
    if card_variant is None or len(chips) != n:
        raise RuntimeError(f"{torch.cuda.get_device_name(0)!r} is no H100 variant, or the chip table {chips}")
    other_variant = "h100-pcie" if card_variant != "h100-pcie" else "h100-sxm"
    products = {"h100-pcie": "NVIDIA-H100-PCIe", "h100-sxm": testing.DEFAULT_PRODUCT}
    ns = consts.DEFAULT_NAMESPACE
    faulthandler.dump_traceback_later(STATE_MACHINE_TIMEOUT_S, exit=True)
    with tempfile.TemporaryDirectory(prefix="cs12-") as tmp:
        sim_server = kubesim.KubeSimServer(port=0).start()
        sim = sim_server.sim
        kubelet = plugin_server = None
        try:
            raw = kubesim.make_client(sim_server.port)
            testing.seed_cluster(raw, ns, node_names=())
            labels = tfd.gather_features({"metadata": {"name": OPERANDS_NODE, "labels": {}}},
                                         dev_root="/dev", driver_root="/", env={}, chips=chips)
            check_features(labels, n)
            labels["kubernetes.io/hostname"] = OPERANDS_NODE
            raw.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": OPERANDS_NODE, "labels": labels}})
            same = sim.add_nodes(FLEET_NODES - 1 - OTHER_VARIANT_NODES - CPU_NODES)
            other = sim.add_nodes(OTHER_VARIANT_NODES, name_prefix="other", template=testing.make_gpu_node(
                "x", variant=other_variant, product=products[other_variant]))
            cpus = sim.add_nodes(CPU_NODES, name_prefix="cpu", template=testing.make_cpu_node("x"), chips=0)
            nodes = [OPERANDS_NODE] + same + other + cpus

            kubelet, plugin_server, capacity = card_device_plugin(sim_server.port, tmp, chips)
            nums = run_state_machine(sim_server.port, ns, OPERANDS_NODE, card_variant, other_variant, nodes, cpus,
                                     capacity)
        finally:
            if plugin_server is not None:
                plugin_server.stop()
            if kubelet is not None:
                kubelet.stop()
            sim_server.stop()
            faulthandler.cancel_dump_traceback_later()
    launched = {k: v for k, v in _build.launches.items() if v}
    if launched:
        raise RuntimeError(f"the state machine launched kernels of the package: {launched}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"state machine on: {smi.stdout.strip() or smi.stderr.strip()}; {json.dumps(nums)}; "
        f"no kernel of the package launched; phase 12 {time.perf_counter() - t_phase:.1f} s")


# phase 13: the node FSMs on the card's node
NODE_FSMS_TIMEOUT_S = 900  # the phase's watchdog
FSM_FLEET_NODES = 256  # an upgrade pass's cost grows faster than the fleet (PERF.md §7)
FSM_SLICE_HOSTS = 4
FSM_SLICES = 8  # 4-host slices, the card's among them
FSM_CPU_NODES = 24
FSM_SOLO_NODES = FSM_FLEET_NODES - FSM_SLICES * FSM_SLICE_HOSTS - FSM_CPU_NODES  # single hosts of the other variant
MAX_FSM_PASSES = 64  # passes a walk may take; one that needs more fails
CARD_SLICE = "slice-card"
PDB_SLICE = "slice-1"  # the slice a PodDisruptionBudget pins
FSM_VERSION = "550.144.03"  # the spec.driver.version the roll goes to
FSM_BUDGET = "25%"
FSM_LAYOUT = "all-1x1"  # the layout the re-partition rolls to
UPGRADE_ORDER = ("upgrade-required", "cordon-required", "wait-for-jobs-required", "pod-deletion-required",
                 "drain-required", "pod-restart-required", "validation-required", "uncordon-required",
                 "upgrade-done")


def _fsm_pod(name: str, ns: str, node: str, labels: dict, cards: int = 0, owned: bool = True) -> dict:
    pod = {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": name, "namespace": ns, "labels": labels},
           "spec": {"nodeName": node, "containers": [{"name": "main", "resources": {}}]},
           "status": {"phase": "Running", "containerStatuses": [{"ready": True}]}}
    if cards:
        pod["spec"]["containers"][0]["resources"] = {"limits": {"nvidia.com/gpu": str(cards)}}
    if owned:
        pod["metadata"]["ownerReferences"] = [{"apiVersion": "batch/v1", "kind": "Job", "name": name, "uid": name}]
    return pod


def fsm_fleet(raw, sim, card: str, labels: dict, card_variant: str, n_slices: int = FSM_SLICES,
              n_solos: int = FSM_SOLO_NODES, n_cpus: int = FSM_CPU_NODES) -> tuple:
    """Create the card's node (``labels``, plus the slice labels of one
    host of ``CARD_SLICE``) and the simulated fleet around it: its 3
    slice peers and ``n_slices - 1`` more 4-host slices of the card's
    variant, ``n_solos`` single hosts of the other H100 variant and
    ``n_cpus`` CPU nodes. Returns ``(slices, nodes, cpu_nodes,
    other_variant)``, ``slices`` each 4-host slice's members."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.kube import testing

    other_variant = "h100-pcie" if card_variant != "h100-pcie" else "h100-sxm"
    products = {"h100-pcie": "NVIDIA-H100-PCIe", "h100-sxm": testing.DEFAULT_PRODUCT}
    hosts = {consts.TFD_SLICE_HOSTS_LABEL: str(FSM_SLICE_HOSTS)}
    labels = {**labels, "kubernetes.io/hostname": card, consts.TFD_SLICE_ID_LABEL: CARD_SLICE, **hosts}
    raw.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": card, "labels": labels}})
    mine = testing.make_gpu_node("x", variant=card_variant, product=products.get(card_variant, "NVIDIA-H100-NVL"))
    slices = {CARD_SLICE: [card] + sim.add_nodes(FSM_SLICE_HOSTS - 1, name_prefix="card-peer", template=mine,
                                                 extra_labels={consts.TFD_SLICE_ID_LABEL: CARD_SLICE, **hosts})}
    for i in range(1, n_slices):
        slices[f"slice-{i}"] = sim.add_nodes(FSM_SLICE_HOSTS, name_prefix=f"slice-{i}-host", template=mine,
                                             extra_labels={consts.TFD_SLICE_ID_LABEL: f"slice-{i}", **hosts})
    solos = sim.add_nodes(n_solos, name_prefix="solo", template=testing.make_gpu_node(
        "x", variant=other_variant, product=products[other_variant]))
    cpus = sim.add_nodes(n_cpus, name_prefix="cpu", template=testing.make_cpu_node("x"), chips=0)
    return slices, [m for names in slices.values() for m in names] + solos + cpus, cpus, other_variant


def run_node_fsms(port: int, ns: str, card: str, other_variant: str, slices: dict, nodes: list, cpu_nodes: list,
                  capacity, workload, slice_manager: dict) -> dict:
    """Converge the port's ``ClusterPolicyController`` over a ``CachedClient``
    on one KubeSim (seeded with the port's CRD and sample, the card's node
    and the fleet ``nodes``; ``other_variant``'s driver pinned in
    ``generationConfigs``, so each variant has its own driver DaemonSet),
    then walk the three node FSMs through the cache: the rolling driver upgrade, remediation and the re-partition
    roll. ``slices`` maps each 4-host slice id to its members (the card's
    is ``CARD_SLICE``); ``capacity(alloc)`` makes the card's node
    advertise every card (``None``) or none (0); ``workload()`` is the
    pod that holds the card's cards; ``slice_manager`` the keyword
    arguments of the card's ``SliceManager``. Raises on any miss; returns
    the times."""
    import threading

    from tpu_operator_torch import consts
    from tpu_operator_torch.api.v1.clusterpolicy_types import State
    from tpu_operator_torch.controllers import remediation, repartition, state_manager
    from tpu_operator_torch.kube import cache, kubesim, testing
    from tpu_operator_torch.kube.client import ConflictError, has_taint
    from tpu_operator_torch.kube.frozen import thaw
    from tpu_operator_torch.sliceman import slice_manager as sm
    from tpu_operator_torch.upgrade import upgrade_state as us

    raw = kubesim.make_client(port)
    nums = {}
    stop = threading.Event()
    cached = cache.CachedClient(kubesim.make_client(port), namespace=ns, resync_interval_s=0)
    request = cached.live._request
    requests = []  # (method, path) of each request the FSMs' client issues
    cached.live._request = lambda method, path, *a, **kw: requests.append((method, path)) or request(
        method, path, *a, **kw)
    ctl = None
    namespace_env = os.environ.get(consts.OPERATOR_NAMESPACE_ENV)
    os.environ[consts.OPERATOR_NAMESPACE_ENV] = ns
    cpus = set(cpu_nodes)
    gpu_names = [n for n in nodes if n not in cpus]
    members = slices[CARD_SLICE]
    slice_of = {m: sid for sid, names in slices.items() for m in names}
    n_slices = len({slice_of.get(n, n) for n in gpu_names})
    cap = us.parse_max_unavailable(FSM_BUDGET, n_slices)
    try:
        if not cached.start_informers(stop, timeout_s=SYNC_TIMEOUT_S):
            raise RuntimeError("the informers did not sync")
        ctl = state_manager.ClusterPolicyController(cached)

        def cr():
            return thaw(cached.get(consts.API_VERSION, consts.CLUSTER_POLICY_KIND, "cluster-policy"))

        def synced():
            _wait_for("the cache to catch up with the server", lambda: _cache_caught_up(cached, raw, ns),
                      SYNC_TIMEOUT_S)

        def controller_pass(states=True):
            ctl.begin_pass()
            try:
                ctl.init(cr())
                return ctl.run_states() if states else []
            finally:
                ctl.end_pass()

        def edit(fn):
            testing.edit_clusterpolicy(raw, fn)
            synced()

        def gpu_nodes():
            return [n for n in cached.list("v1", "Node") if state_manager.has_gpu_labels(n)]

        def labels():
            return {n["metadata"]["name"]: (n["metadata"].get("labels") or {}, n.get("spec") or {})
                    for n in raw.list("v1", "Node")}

        def kubelet():
            testing.simulate_kubelet_nodes(raw, ns, nodes)
            synced()

        # 1. the operands converge, one driver DaemonSet a variant
        version = cr()["spec"]["driver"]["version"]
        edit(lambda cp: cp["spec"]["driver"].__setitem__("generationConfigs", {other_variant: version}))
        t0 = time.perf_counter()
        for passes in range(1, MAX_PASSES + 1):
            results = controller_pass()
            errors = {s: repr(o) for s, o in results if isinstance(o, Exception)}
            waiting = [s for s, o in results if ctl.is_state_enabled(s) and o != State.READY]
            if errors:
                raise RuntimeError(f"pass {passes}: states raised {errors}")
            kubelet()
            if not waiting:
                break
        else:
            raise RuntimeError(f"{MAX_PASSES} passes and {waiting} are not READY")
        drivers = sorted(d["metadata"]["name"] for d in raw.list("apps/v1", "DaemonSet", ns)
                         if d["metadata"]["name"].startswith(consts.DRIVER_APP + "-"))
        if len(drivers) != 2 or ctl.tpu_node_count != len(gpu_names):
            raise RuntimeError(f"driver DaemonSets {drivers}; {ctl.tpu_node_count} GPU nodes of {len(gpu_names)}")
        log(f"node FSMs: {len(gpu_names)} GPU nodes in {n_slices} slices ({len(slices)} of {FSM_SLICE_HOSTS} hosts), "
            f"{len(cpus)} CPU nodes; operands READY after {passes} passes in {(time.perf_counter() - t0) * 1e3:.1f} ms; "
            f"driver DaemonSets {drivers}")

        # 2. the rolling driver upgrade
        try:
            raw.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": "default"}})
        except ConflictError:
            pass
        pod = workload()
        raw.create(pod)
        pinned_host = slices[PDB_SLICE][0]
        raw.create(_fsm_pod("gang-0", "default", pinned_host, {"app": "gang"}, cards=1))
        raw.create({"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                    "metadata": {"name": "gang-pdb", "namespace": "default"},
                    "spec": {"minAvailable": 1, "selector": {"matchLabels": {"app": "gang"}}}})
        card_version = _labels_of(raw, card).get(consts.DRIVER_VERSION_LABEL)
        old = next(p["metadata"] for p in raw.list("v1", "Pod", ns, field_selector={"spec.nodeName": card})
                   if p["metadata"]["labels"]["app"] in drivers)
        driver_pod, drv = old["name"], old["labels"]["app"]
        before = {d: raw.get("apps/v1", "DaemonSet", d, ns)["spec"]["template"]["metadata"]["annotations"][
            consts.LAST_APPLIED_HASH_ANNOTATION] for d in drivers}
        edit(lambda cp: cp["spec"]["driver"].update(version=FSM_VERSION, generationConfigs={
            other_variant: FSM_VERSION}, upgradePolicy={
            "autoUpgrade": True, "maxParallelUpgrades": FSM_FLEET_NODES, "maxUnavailable": FSM_BUDGET,
            "drain": {"enable": True, "timeoutSeconds": 300}}))
        controller_pass()
        synced()
        after = {d: raw.get("apps/v1", "DaemonSet", d, ns)["spec"]["template"]["metadata"]["annotations"][
            consts.LAST_APPLIED_HASH_ANNOTATION] for d in drivers}
        policy = ctl.cp.spec.driver.upgrade_policy
        if any(before[d] == after[d] for d in drivers) or policy is None or not policy.auto_upgrade:
            raise RuntimeError(f"the version edit left driver hashes {before} -> {after}; policy {policy}")
        mgr = us.ClusterUpgradeStateManager(cached, ns)
        active = set(us.ACTIVE_STATES)
        seen, pass_ms, worst = [], [], 0
        pinned_passes, pdb_deleted_at = 0, None
        cordoned_at = uncordoned_at = None
        requests.clear()
        t_walk = time.perf_counter()
        for passes in range(1, MAX_FSM_PASSES + 1):
            t0 = time.perf_counter()
            state = mgr.build_state()
            entered = {e.node["metadata"]["name"]: e.state for e in state.all()}.get(card)
            mgr.apply_state(state, policy)
            pass_ms.append((time.perf_counter() - t0) * 1e3)
            now = labels()
            for s in (entered, now[card][0].get(consts.UPGRADE_STATE_LABEL)):
                if s and (not seen or seen[-1] != s):
                    seen.append(s)
            card_state, unsched = seen[-1], now[card][1].get("unschedulable", False)
            if card_state in active - {us.STATE_CORDON_REQUIRED} and not unsched:
                raise RuntimeError(f"pass {passes}: the card's node is {card_state} but schedulable")
            if unsched and cordoned_at is None:
                cordoned_at = time.perf_counter()
            if cordoned_at and not unsched and uncordoned_at is None:
                uncordoned_at = time.perf_counter()
                if {now[m][0].get(consts.UPGRADE_STATE_LABEL) for m in members} != {us.STATE_DONE} or any(
                        now[m][1].get("unschedulable") for m in members):
                    raise RuntimeError(f"pass {passes}: {CARD_SLICE} did not return to service together: "
                                       f"{ {m: now[m][0].get(consts.UPGRADE_STATE_LABEL) for m in members} }")
            together = {now[m][0].get(consts.UPGRADE_STATE_LABEL) in active for m in members}
            if len(together) != 1:
                raise RuntimeError(f"pass {passes}: {CARD_SLICE}'s members are not active together: "
                                   f"{ {m: now[m][0].get(consts.UPGRADE_STATE_LABEL) for m in members} }")
            disrupted = {slice_of.get(n, n) for n in gpu_names if now[n][0].get(consts.UPGRADE_STATE_LABEL) in (
                active | {us.STATE_FAILED})}
            worst = max(worst, len(disrupted))
            if len(disrupted) > cap:
                raise RuntimeError(f"pass {passes}: {len(disrupted)} slices disrupted, over {FSM_BUDGET} ({cap})")
            if pdb_deleted_at is None and PDB_SLICE in mgr.pinned_slices:
                held = {now[m][0].get(consts.UPGRADE_STATE_LABEL) for m in slices[PDB_SLICE]}
                if held != {us.STATE_DRAIN_REQUIRED} or raw.get_or_none("v1", "Pod", "gang-0", "default") is None:
                    raise RuntimeError(f"pass {passes}: {PDB_SLICE} pinned but {held}")
                pinned_passes += 1
                if pinned_passes == 2:
                    raw.delete("policy/v1", "PodDisruptionBudget", "gang-pdb", "default")
                    pdb_deleted_at = passes
            if all(now[n][0].get(consts.UPGRADE_STATE_LABEL) == us.STATE_DONE for n in gpu_names):
                break
            kubelet()
        else:
            raise RuntimeError(f"{MAX_FSM_PASSES} upgrade passes and "
                               f"{sum(now[n][0].get(consts.UPGRADE_STATE_LABEL) != us.STATE_DONE for n in gpu_names)} "
                               f"GPU nodes are not {us.STATE_DONE}")
        nums["upgrade_passes"] = passes
        nums["upgrade_s"] = time.perf_counter() - t_walk
        nums["upgrade_pass_ms_mean"] = sum(pass_ms) / len(pass_ms)
        nums["upgrade_pass_ms_max"] = max(pass_ms)
        nums["card_cordon_to_uncordon_s"] = uncordoned_at - cordoned_at if uncordoned_at and cordoned_at else None
        evictions = [p for m, p in requests if m == "POST" and p.endswith("/eviction")]
        new = raw.get("v1", "Pod", driver_pod, ns)["metadata"]
        ann = raw.get("v1", "Node", card)["metadata"].get("annotations") or {}
        labelled_cpu = [n for n in cpus if consts.UPGRADE_STATE_LABEL in _labels_of(raw, n)]
        misses = {
            "order": seen != list(UPGRADE_ORDER),
            "cordon": nums["card_cordon_to_uncordon_s"] is None,
            "eviction": not any(p.endswith(f"/namespaces/default/pods/{pod['metadata']['name']}/eviction")
                                for p in evictions) or raw.get_or_none("v1", "Pod", pod["metadata"]["name"],
                                                                       "default") is not None,
            "driver pod": new["uid"] == old["uid"] or new["annotations"][consts.LAST_APPLIED_HASH_ANNOTATION] != after[
                drv],
            "previous version": not card_version or ann.get(consts.UPGRADE_PREVIOUS_VERSION_ANNOTATION) != card_version,
            "pdb": pdb_deleted_at is None or raw.get_or_none("v1", "Pod", "gang-0", "default") is not None,
            "cpu": bool(labelled_cpu),
        }
        if any(misses.values()):
            raise RuntimeError(f"upgrade walk: {[k for k, v in misses.items() if v]}; the card's node went {seen}; "
                               f"evictions {evictions[:5]}; CPU nodes labelled {labelled_cpu[:5]}")
        synced()
        requests.clear()
        mgr.apply_state(mgr.build_state(), policy)
        writes = [r for r in requests if r[0] != "GET"]
        if writes:
            raise RuntimeError(f"a pass over the rolled fleet wrote {writes[:5]}")
        log(f"upgrade: every one of {len(gpu_names)} GPU nodes {us.STATE_DONE} after {passes} passes in "
            f"{nums['upgrade_s']:.2f} s (a pass {nums['upgrade_pass_ms_mean']:.1f} ms mean, "
            f"{nums['upgrade_pass_ms_max']:.1f} ms at most); the card's node went {' -> '.join(seen)}, cordoned "
            f"{nums['card_cordon_to_uncordon_s']:.2f} s, {pod['metadata']['name']} evicted, {driver_pod} recreated "
            f"at {after[drv]}, previous version {card_version}; at most {worst} of {n_slices} slices disrupted "
            f"(cap {cap}); {PDB_SLICE} pinned in drain for {pinned_passes} passes until its PDB went; "
            f"{len(evictions)} evictions; one more pass wrote nothing")

        # 3. remediation
        edit(lambda cp: cp["spec"].__setitem__("remediation", {
            "enabled": True, "backoffSeconds": 0, "maxAttempts": 2, "maxUnavailable": FSM_BUDGET}))
        controller_pass(states=False)
        rspec = ctl.cp.spec.remediation
        rctl = remediation.NodeRemediationController(cached, ns)
        raw.create(_fsm_pod(f"user-job-{card}", ns, card, {"app": "user-job"}, owned=False))
        operands = sorted(p["metadata"]["name"] for p in raw.list("v1", "Pod", ns)
                          if p["spec"].get("nodeName") == card and p["metadata"]["labels"].get("app", "").startswith(
                              consts.OPERAND_APP_PREFIX))
        t_down = time.perf_counter()
        capacity(0)
        synced()
        verdict = rctl._verdict(thaw(cached.get("v1", "Node", card)), *rctl._namespace_pods_by_node())
        if f"0 allocatable {consts.GPU_RESOURCE}" not in verdict.reasons:
            raise RuntimeError(f"the card's verdict {verdict.reasons}")
        rseen, deleted = [], []
        for rpasses in range(1, MAX_FSM_PASSES + 1):
            requests.clear()
            summary = rctl.reconcile(gpu_nodes(), rspec, ns)
            deleted += [p.rsplit("/", 1)[1] for m, p in requests if m == "DELETE" and "/pods/" in p]
            if summary.breaker_open or summary.unhealthy_hosts != [card]:
                raise RuntimeError(f"pass {rpasses}: breaker {summary.breaker_open}, unhealthy "
                                   f"{summary.unhealthy_hosts[:5]}")
            node = raw.get("v1", "Node", card)
            rstate = (node["metadata"].get("labels") or {}).get(consts.REMEDIATION_STATE_LABEL)
            rseen.append(rstate)
            if rstate == consts.REMEDIATION_STATE_QUARANTINED:
                break
            kubelet()
        else:
            raise RuntimeError(f"{MAX_FSM_PASSES} passes and the card's node is {rseen[-1]}")
        nums["quarantine_s"] = time.perf_counter() - t_down
        quarantine = (node["spec"].get("unschedulable"), has_taint(node, consts.REPAIR_TAINT_KEY, consts.REPAIR_PENDING),
                      node["metadata"]["labels"].get(consts.REPAIR_LABEL))
        touched = [n for n, (lab, spec) in labels().items() if n != card and (
            consts.REMEDIATION_STATE_LABEL in lab or consts.REPAIR_LABEL in lab or spec.get("unschedulable")
            or any(t.get("key") == consts.REPAIR_TAINT_KEY for t in spec.get("taints") or []))]
        if (quarantine != (True, True, consts.REPAIR_PENDING) or sorted(deleted) != operands or touched
                or raw.get_or_none("v1", "Pod", f"user-job-{card}", ns) is None):
            raise RuntimeError(f"remediation: quarantine {quarantine}, deleted {deleted} of operands {operands}, "
                               f"other nodes touched {touched[:5]}, states {rseen}")
        t_up = time.perf_counter()
        capacity(None)
        kubelet()
        for upasses in range(1, MAX_FSM_PASSES + 1):
            rctl.reconcile(gpu_nodes(), rspec, ns)
            node = raw.get("v1", "Node", card)
            rstate = (node["metadata"].get("labels") or {}).get(consts.REMEDIATION_STATE_LABEL)
            if rstate == consts.REMEDIATION_STATE_RECOVERED:
                break
            kubelet()
        else:
            raise RuntimeError(f"{MAX_FSM_PASSES} passes and the card's node is {rstate}")
        nums["recover_s"] = time.perf_counter() - t_up
        if (node["spec"].get("unschedulable") or has_taint(node, consts.REPAIR_TAINT_KEY)
                or consts.REPAIR_LABEL in node["metadata"]["labels"]):
            raise RuntimeError(f"recovered, but {node['spec']} {node['metadata']['labels']}")
        log(f"remediation: every card unhealthy -> the card's node {' -> '.join(rseen)} in {rpasses} passes, "
            f"{nums['quarantine_s']:.2f} s (verdict {verdict.reasons}; restart rung deleted {deleted}, left "
            f"user-job-{card}; no other node touched); cards healthy -> recovered in {upasses} passes, "
            f"{nums['recover_s']:.2f} s, schedulable, no taint or label")

        # 4. the re-partition roll
        edit(lambda cp: cp["spec"]["sliceManager"].update(
            config={"name": "slice-configs", "default": FSM_LAYOUT}, maxUnavailable=FSM_BUDGET))
        controller_pass(states=False)
        sspec = ctl.cp.spec.slice_manager
        pctl = repartition.SliceRepartitionController(cached, ns)
        manager = sm.SliceManager(raw, card, **slice_manager)
        sm_ms, skipped = [], None
        t_roll = time.perf_counter()
        for ppasses in range(1, MAX_FSM_PASSES + 1):
            summary = pctl.reconcile(gpu_nodes(), sspec, ns)
            if summary.disrupted_slices > cap:
                raise RuntimeError(f"pass {ppasses}: {summary.disrupted_slices} slices rolling, over {cap}")
            synced()
            now = labels()
            rolling = [n for n in gpu_names if now[n][0].get(consts.REPARTITION_STATE_LABEL)
                       == consts.REPARTITION_STATE_ROLLING]
            if card in rolling:
                got = {m: (now[m][0].get(consts.SLICE_CONFIG_LABEL), now[m][0].get(consts.SLICE_CONFIG_STATE_LABEL))
                       for m in members}
                if skipped is None and (set(got.values()) != {(FSM_LAYOUT, sm.STATE_PENDING)} or not set(
                        members) <= set(rolling)):
                    raise RuntimeError(f"{CARD_SLICE} admitted as {got}")
                verdict = rctl._verdict(thaw(cached.get("v1", "Node", card)), *rctl._namespace_pods_by_node())
                rsum = rctl.reconcile(gpu_nodes(), rspec, ns)
                if verdict.skip_reason != "in-flight slice re-partition roll" or rsum.skipped < len(members):
                    raise RuntimeError(f"remediation during the roll: {verdict.skip_reason!r}, {rsum.skipped} skipped")
                skipped = rsum.skipped
                t0 = time.perf_counter()
                result = manager.reconcile_once()
                sm_ms.append((time.perf_counter() - t0) * 1e3)
                if result != sm.STATE_SUCCESS:
                    raise RuntimeError(f"the card's slice manager: {result}")
            for n in rolling:
                if n != card and now[n][0].get(consts.SLICE_CONFIG_STATE_LABEL) != sm.STATE_SUCCESS:
                    raw.patch_labels("v1", "Node", n, labels={consts.SLICE_CONFIG_STATE_LABEL: sm.STATE_SUCCESS})
            done = [n for n in gpu_names if now[n][0].get(consts.SLICE_CONFIG_LABEL) == FSM_LAYOUT
                    and now[n][0].get(consts.SLICE_CONFIG_STATE_LABEL) == sm.STATE_SUCCESS and n not in rolling]
            if len(done) == len(gpu_names):
                break
            synced()
        else:
            raise RuntimeError(f"{MAX_FSM_PASSES} passes and {len(gpu_names) - len(done)} GPU nodes not on "
                               f"{FSM_LAYOUT}")
        nums["repartition_passes"] = ppasses
        nums["repartition_s"] = time.perf_counter() - t_roll
        nums["slice_manager_ms"] = sm_ms
        part = sm.read_partition_state(slice_manager["partition_file"])
        if skipped is None or not sm_ms or (part or {}).get("config") != FSM_LAYOUT:
            raise RuntimeError(f"the card's slice was never rolled: partition {part}")
        log(f"re-partition: every GPU node on {FSM_LAYOUT} after {ppasses} passes in {nums['repartition_s']:.2f} s; "
            f"the card's SliceManager.reconcile_once {', '.join(f'{t:.1f}' for t in sm_ms)} ms "
            f"({len(part['subslices'])} subslices of {part['shape']}); remediation skipped the card's node "
            f"while it rolled ({skipped} nodes skipped); {pctl.stats()['rolls_completed_total']} holds released")
        return nums
    finally:
        cached.live._request = request
        _stop_controller(cached, stop, ctl, raw, namespace_env)


def phase_node_fsms() -> None:
    """The node FSMs on the card's node (phase 13): the card's node, one
    host of ``CARD_SLICE``, joins a fleet of 4-host slices, single hosts
    of the other H100 variant and CPU nodes on one KubeSim; the device
    plugin over the real cards advertises the capacity remediation reads
    and answers the kubelet's allocation of the workload's cards; the
    port's ``SliceManager`` applies the card's layout;
    ``run_node_fsms`` walks the three FSMs."""
    from tpu_operator_torch import _build
    from tpu_operator_torch import consts
    from tpu_operator_torch.discovery import tfd
    from tpu_operator_torch.kube import kubesim, testing
    from tpu_operator_torch.native import gpuinfo
    from tpu_operator_torch.workloads.topology import device_generation

    t_phase = time.perf_counter()
    _build.reset_launches()
    n = torch.cuda.device_count()
    chips = gpuinfo.chip_summary()
    card_variant = device_generation(torch.cuda.get_device_name(0))
    if card_variant is None or len(chips) != n:
        raise RuntimeError(f"{torch.cuda.get_device_name(0)!r} is no H100 variant, or the chip table {chips}")
    ns = consts.DEFAULT_NAMESPACE
    faulthandler.dump_traceback_later(NODE_FSMS_TIMEOUT_S, exit=True)
    with tempfile.TemporaryDirectory(prefix="cs13-") as tmp:
        sim_server = kubesim.KubeSimServer(port=0).start()
        sim = sim_server.sim
        kubelet = plugin_server = None
        try:
            raw = kubesim.make_client(sim_server.port)
            testing.seed_cluster(raw, ns, node_names=())
            labels = tfd.gather_features({"metadata": {"name": OPERANDS_NODE, "labels": {}}},
                                         dev_root="/dev", driver_root="/", env={}, chips=chips)
            check_features(labels, n)
            slices, nodes, cpus, other_variant = fsm_fleet(raw, sim, OPERANDS_NODE, labels, card_variant)

            kubelet, plugin_server, capacity = card_device_plugin(sim_server.port, tmp, chips)
            def workload():
                """A Job's pod on the card's node holding every card the
                kubelet allocates it."""
                resp = kubelet.allocate(consts.GPU_RESOURCE, n)
                cards = [d.name.split("=", 1)[1] for d in resp.container_responses[0].cdi_devices]
                if len(cards) != n:
                    raise RuntimeError(f"the kubelet allocated {cards}")
                pod = _fsm_pod("card-train", "default", OPERANDS_NODE, {"app": "train"}, cards=n)
                pod["metadata"]["annotations"] = {"chip-smoke.example.com/cards": ",".join(cards)}
                return pod

            capacity(None)
            config_file, clients_file = os.path.join(tmp, "slice-configs.yaml"), os.path.join(tmp, "clients.yaml")
            with open(config_file, "w") as f:
                json.dump({"version": "v1", "slice-configs": {FSM_LAYOUT: [
                    {"devices": "all", "partitioned": True, "layout": {"shape": "1x1"}}]}}, f)  # JSON is YAML
            with open(clients_file, "w") as f:
                json.dump({"version": "v1", "kubernetes-labels": [
                    consts.DEPLOY_LABEL_PREFIX + consts.COMPONENT_DEVICE_PLUGIN]}, f)
            slice_manager = {"config_file": config_file, "chip_clients_file": clients_file,
                             "partition_file": os.path.join(tmp, "partitions.json"),
                             "cdi_spec_path": os.path.join(tmp, "cdi", "nvidia.json"), "dev_root": "/dev",
                             "driver_root": "/"}
            nums = run_node_fsms(sim_server.port, ns, OPERANDS_NODE, other_variant, slices, nodes, cpus, capacity,
                                 workload, slice_manager)
        finally:
            if plugin_server is not None:
                plugin_server.stop()
            if kubelet is not None:
                kubelet.stop()
            sim_server.stop()
            faulthandler.cancel_dump_traceback_later()
    launched = {k: v for k, v in _build.launches.items() if v}
    if launched:
        raise RuntimeError(f"the node FSMs launched kernels of the package: {launched}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"node FSMs on: {smi.stdout.strip() or smi.stderr.strip()}; {json.dumps(nums)}; "
        f"no kernel of the package launched; phase 13 {time.perf_counter() - t_phase:.1f} s")


# phase 14: the reconcilers on the card's node
RECONCILERS_TIMEOUT_S = 900  # the phase's watchdog
RECONCILE_SLICES = 150  # 4-host slices of the card's variant at FLEET_NODES, the card's among them
RECONCILE_SOLOS = 300  # single hosts of the other H100 variant
RECONCILE_CPUS = FLEET_NODES - RECONCILE_SLICES * FSM_SLICE_HOSTS - RECONCILE_SOLOS
MAX_RECONCILE_PASSES = 8  # full passes the 1000-node world gets to read READY with every slice ready
STEADY_PASSES = 5
ROLLOUT_SLICES = 16  # 4-host slices of the roll's world: 64 nodes (PERF.md §7: a roll's cost outgrows the fleet)
MAX_ROLLOUT_TICKS = 100  # ticks a roll may take; one that needs more fails
ROLLOUT = {"enabled": True, "canary": 1, "waves": ["25%"], "observeSeconds": 0}
ROLL_OLD = "550.90.07"  # what the simulated fleet's nodes report (kube/testing.py DEFAULT_DRIVER_VERSION)
ROLL_NEW = FSM_VERSION
ROLL_BAD = "550.163.01"  # registered bad: its validator readings at half the card's rates
PASS_SPANS = ("pass.reconcile", "pass.shard_scope", "fsm.remediation", "fsm.rollout", "fsm.repartition",
              "pass.slices")
PREDICATE_LABEL = "chip-smoke.example.com/note"  # outside the watched prefixes


class _KeyLog:
    """The event router's manager: records every key it is handed (the
    keyed workqueue and its workers belong to the manager)."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._keys = []

    def enqueue(self, key, delay: float = 0.0) -> None:
        with self._lock:
            self._keys.append(key)

    def take(self) -> list:
        with self._lock:
            out, self._keys = self._keys, []
        return out


class _ScopedShard:
    """A replica's shard view that owns every slice but not the full pass:
    the reconciler runs its scoped pass (``pass.shard_scope``)."""

    def owns_full_pass(self) -> bool:
        return False

    def covers_slice(self, sid: str) -> bool:
        return True


def _reconciler_world(port: int, ns: str):
    """A ``CachedClient`` over the KubeSim at ``port`` with its informers
    synced, the operator namespace set, and a ``synced()`` that waits for
    the cache to catch up with the server."""
    import threading

    from tpu_operator_torch import consts
    from tpu_operator_torch.kube import cache, kubesim

    raw = kubesim.make_client(port)
    stop = threading.Event()
    cached = cache.CachedClient(kubesim.make_client(port), namespace=ns, resync_interval_s=0)
    namespace_env = os.environ.get(consts.OPERATOR_NAMESPACE_ENV)
    os.environ[consts.OPERATOR_NAMESPACE_ENV] = ns
    if not cached.start_informers(stop, timeout_s=SYNC_TIMEOUT_S):
        _stop_controller(cached, stop, None, raw, namespace_env)
        raise RuntimeError("the informers did not sync")

    def synced():
        _wait_for("the cache to catch up with the server", lambda: _cache_caught_up(cached, raw, ns), SYNC_TIMEOUT_S)

    return raw, cached, stop, namespace_env, synced


def run_reconcile_pass(port: int, ns: str, sim, card: str, slices: dict, nodes: list, cpu_nodes: list,
                       capacity) -> dict:
    """Part A of phase 14: the port's ``ClusterPolicyReconciler`` over a
    ``CachedClient`` on the 1000-node KubeSim at ``port`` (the card's node one
    host of ``CARD_SLICE``) converges to READY with its status and one
    ``Ready`` Event; five steady passes and one scoped pass write nothing;
    ``node_event_needs_reconcile`` reads the cache's events; the event router
    sends the card's validator flip to ``CARD_SLICE``'s key alone, and the
    delta reconciler's slice pass moves ``status.slices`` without a full
    pass. ``capacity(alloc)`` makes ``alloc`` of the card's cards
    allocatable. Raises on any miss; returns the times."""
    import queue

    from tpu_operator_torch import consts
    from tpu_operator_torch.api.v1.clusterpolicy_types import State
    from tpu_operator_torch.controllers import clusterpolicy_controller as cpc
    from tpu_operator_torch.controllers import delta
    from tpu_operator_torch.controllers.slice_status import VALIDATOR_APP
    from tpu_operator_torch.kube import testing
    from tpu_operator_torch.obs import trace

    raw, cached, stop, namespace_env, synced = _reconciler_world(port, ns)
    rec = None
    nums = {}
    cpus = set(cpu_nodes)
    in_slices = {m for names in slices.values() for m in names}
    units = len(slices) + sum(1 for n in nodes if n not in cpus and n not in in_slices)
    members = slices[CARD_SLICE]
    try:
        rec = cpc.ClusterPolicyReconciler(cached)

        def cp():
            return raw.get(consts.API_VERSION, consts.CLUSTER_POLICY_KIND, "cluster-policy")

        # 1. convergence: full passes and the simulated kubelets in turn
        t0 = time.perf_counter()
        for passes in range(1, MAX_RECONCILE_PASSES + 1):
            res = rec.reconcile()
            slices_now = (cp().get("status") or {}).get("slices") or {}
            if res.ready and slices_now.get("ready") == slices_now.get("total") == units:
                break
            testing.simulate_kubelet_nodes(raw, ns, nodes)
            synced()
        else:
            raise RuntimeError(f"{MAX_RECONCILE_PASSES} passes: {res}, status {cp().get('status')}")
        nums["ready_passes"], nums["ready_s"] = passes, time.perf_counter() - t0
        status = cp()["status"]
        conds = {c["type"]: c for c in status.get("conditions") or []}
        ready_events = [e for e in raw.list("v1", "Event", ns) if e.get("reason") == "Ready"]
        labelled_cpu = [n for n in cpus if any(k.startswith(consts.DEPLOY_LABEL_PREFIX) for k in _labels_of(raw, n))]
        if (status.get("state") != State.READY or conds.get("Ready", {}).get("status") != "True"
                or [(e["type"], e["involvedObject"]["kind"], e.get("count")) for e in ready_events]
                != [("Normal", consts.CLUSTER_POLICY_KIND, 1)] or labelled_cpu):
            raise RuntimeError(f"status {status}; Ready events {ready_events}; CPU nodes labelled {labelled_cpu[:5]}")
        log(f"reconcilers: {len(nodes)} nodes ({units} GPU slice units, {len(cpus)} CPU nodes) READY after "
            f"{passes} passes in {nums['ready_s']:.2f} s; status.slices {status['slices']}; one Normal Ready Event "
            f"({ready_events[0]['message']!r}); no CPU node labelled")

        # 2. steady passes: no write, every span of the pass
        synced()
        trace.TRACER.reset()
        trace.TRACER.enable()
        writes0 = sim.writes_total()
        steady = []
        try:
            for _ in range(STEADY_PASSES):
                t0 = time.perf_counter()
                res = rec.reconcile()
                steady.append((time.perf_counter() - t0) * 1e3)
                if not res.ready:
                    raise RuntimeError(f"a steady pass read {res}")
            layers = dict(rec.last_trace_summary)
            rec.shard_state = _ScopedShard()
            t0 = time.perf_counter()
            res = rec.reconcile()
            scoped_ms = (time.perf_counter() - t0) * 1e3
            rec.shard_state = None
            with tempfile.NamedTemporaryFile("w+", suffix=".json") as f:
                trace.TRACER.export_chrome(f.name)
                with open(f.name) as g:
                    names = {ev["name"] for ev in json.load(g)["traceEvents"]}
        finally:
            rec.shard_state = None
            trace.TRACER.disable()
            trace.TRACER.reset()
        writes = sim.writes_total() - writes0
        missing = [s for s in PASS_SPANS if s not in names]
        if writes or missing or not res.ready or not {"pass", "fsm"} <= set(layers):
            raise RuntimeError(f"steady passes: {writes} writes, spans missing {missing}, scoped pass {res}, "
                               f"layers {sorted(layers)}")
        nums["steady_ms_mean"], nums["steady_ms_max"] = sum(steady) / len(steady), max(steady)
        nums["scoped_ms"] = scoped_ms
        log(f"steady: {STEADY_PASSES} traced passes {nums['steady_ms_mean']:.1f} ms mean, "
            f"{nums['steady_ms_max']:.1f} ms at most, and one scoped pass {scoped_ms:.1f} ms: 0 writes; spans "
            f"{', '.join(PASS_SPANS)}; layers of the last full pass {sorted(layers)}")

        # 3. the predicate over the cache's (old, new)
        seen = {card: cached.get("v1", "Node", card)}
        events = queue.Queue()

        def on_node(etype, obj):
            if obj.get("kind") == "Node" and obj["metadata"]["name"] == card:
                events.put((etype, seen.get(card), obj))
                seen[card] = obj

        cached.add_event_hook(on_node)

        def delivered(what, changed):
            """The next (old, new) of the card's node where ``changed``."""
            deadline = time.monotonic() + SYNC_TIMEOUT_S
            while time.monotonic() < deadline:
                try:
                    etype, old, new = events.get(timeout=1.0)
                except queue.Empty:
                    continue
                if changed(old or {}, new):
                    return cpc.node_event_needs_reconcile(etype, old, new)
            raise RuntimeError(f"no event of the card's node for {what}")

        def alloc(node):
            return (node.get("status") or {}).get("allocatable", {}).get(consts.GPU_RESOURCE)

        def label(key):
            return lambda old, new: (old.get("metadata", {}).get("labels") or {}).get(key) != (
                new["metadata"].get("labels") or {}).get(key)

        n = capacity(None)
        verdicts = {}
        capacity(n - 1)
        verdicts["one card unhealthy"] = delivered("mark_unhealthy", lambda old, new: alloc(new) == str(n - 1))
        capacity(None)
        delivered("mark_healthy", lambda old, new: alloc(new) == str(n))
        product = _labels_of(raw, card)[consts.GPU_PRODUCT_LABEL]
        raw.patch_labels("v1", "Node", card, labels={consts.GPU_PRODUCT_LABEL: product + "-edited"})
        verdicts["product label"] = delivered("the product label", label(consts.GPU_PRODUCT_LABEL))
        raw.patch_labels("v1", "Node", card, labels={consts.GPU_PRODUCT_LABEL: product})
        delivered("the product label back", label(consts.GPU_PRODUCT_LABEL))
        raw.patch_labels("v1", "Node", card, labels={PREDICATE_LABEL: "x"})
        verdicts["another label"] = delivered("another label", label(PREDICATE_LABEL))
        raw.patch_labels("v1", "Node", card, labels={PREDICATE_LABEL: None})
        delivered("another label off", label(PREDICATE_LABEL))
        if verdicts != {"one card unhealthy": True, "product label": True, "another label": False}:
            raise RuntimeError(f"node_event_needs_reconcile: {verdicts}")
        log(f"predicate over the cache's events: {verdicts}")

        # 4. the delta path: the validator flip routed to the slice's key
        synced()
        keys = _KeyLog()
        router = delta.EventRouter(keys, rec.delta, "cp", "upgrade")
        router.enabled = True
        validator = next(p for p in raw.list("v1", "Pod", ns, field_selector={"spec.nodeName": card})
                         if p["metadata"]["labels"].get("app") == VALIDATOR_APP)
        for m in members:
            router.on_event("MODIFIED", cached.get("v1", "Node", m))
        router.on_event("MODIFIED", cached.get("v1", "Pod", validator["metadata"]["name"], ns))
        keys.take()
        cached.add_event_hook(router.on_event)
        passes = rec.passes_total
        ready0 = cp()["status"]["slices"]["ready"]
        sub_ms, echoes = [], []
        for ready, want in ((False, "false"), (True, "true")):
            pod = raw.get("v1", "Pod", validator["metadata"]["name"], ns)
            pod["status"] = {"phase": "Running", "containerStatuses": [{"ready": ready}]}
            raw.update_status(pod)
            got = []
            _wait_for("the router's key", lambda: got.extend(keys.take()) or got, SYNC_TIMEOUT_S)
            synced()
            got += keys.take()
            if got != [(delta.SLICE_KIND, CARD_SLICE)]:
                raise RuntimeError(f"the validator flip to ready={ready} routed {got}")
            t0 = time.perf_counter()
            rec.delta.reconcile_slice(CARD_SLICE)
            sub_ms.append((time.perf_counter() - t0) * 1e3)
            synced()
            # the pass's own writes echo through the watch: the verdict
            # labels (dropped once the mirror agrees) and the CR's status
            echoes += keys.take()
            verdict = {_labels_of(raw, m).get(consts.SLICE_READY_LABEL) for m in members}
            got_ready = cp()["status"]["slices"]["ready"]
            if verdict != {want} or got_ready != ready0 - (not ready) or rec.passes_total != passes:
                raise RuntimeError(f"slice pass after ready={ready}: {CARD_SLICE}'s verdicts {verdict}, "
                                   f"status.slices.ready {got_ready} of {ready0}, full passes "
                                   f"{rec.passes_total - passes}")
        nums["slice_pass_ms"] = sub_ms
        log(f"delta: the card's validator not ready -> {[(delta.SLICE_KIND, CARD_SLICE)]} alone; "
            f"reconcile_slice({CARD_SLICE!r}) {sub_ms[0]:.1f} ms lowered status.slices.ready {ready0} -> "
            f"{ready0 - 1} and labelled its {len(members)} hosts false; the flip back restored it in "
            f"{sub_ms[1]:.1f} ms; no full pass (a steady full pass {nums['steady_ms_mean']:.1f} ms); the passes' own "
            f"writes echoed as {sorted(set(map(str, echoes)))}")
        return nums
    finally:
        _stop_controller(cached, stop, rec.ctrl if rec is not None else None, raw, namespace_env)


def run_rollout(port: int, ns: str, card: str, slices: dict, nodes: list) -> dict:
    """Part B of phase 14: on the KubeSim at ``port`` (``slices``, 4-host
    slices, the card's node in ``CARD_SLICE``), the ClusterPolicy and upgrade
    reconcilers over a ``CachedClient`` stage a clean driver roll to
    ``complete`` and roll a bad version back from its canary. A tick is a
    full pass, a kubelet sweep and an upgrade pass. Raises on any miss;
    returns the ticks and seconds."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.controllers import clusterpolicy_controller as cpc
    from tpu_operator_torch.controllers import rollout as ro
    from tpu_operator_torch.kube import testing
    from tpu_operator_torch.obs import flight
    from tpu_operator_torch.upgrade import upgrade_controller as uc
    from tpu_operator_torch.upgrade import upgrade_state as us

    raw, cached, stop, namespace_env, synced = _reconciler_world(port, ns)
    rec = None
    nums = {}
    slice_of = {m: sid for sid, names in slices.items() for m in names}
    cap = us.parse_max_unavailable(FSM_BUDGET, len(slices))
    pending = (consts.UPGRADE_STATE_UPGRADE_REQUIRED,) + tuple(consts.UPGRADE_ACTIVE_STATES)
    try:
        testing.edit_clusterpolicy(raw, lambda cr: (cr["spec"]["driver"].update(version=ROLL_OLD, upgradePolicy={
            "autoUpgrade": True, "maxParallelUpgrades": len(nodes), "maxUnavailable": FSM_BUDGET,
            "drain": {"enable": True, "timeoutSeconds": 300}}), cr["spec"].__setitem__("rollout", dict(ROLLOUT))))
        synced()
        rec, upg = cpc.ClusterPolicyReconciler(cached), uc.UpgradeReconciler(cached, ns)
        worst = [0]

        def tick():
            rec.reconcile()
            testing.simulate_kubelet_nodes(raw, ns, nodes)
            synced()
            upg.reconcile()
            synced()
            now = {n["metadata"]["name"]: n["metadata"].get("labels") or {} for n in raw.list("v1", "Node")}
            disrupted = {slice_of[n] for n, lab in now.items() if lab.get(consts.UPGRADE_STATE_LABEL) in (
                tuple(consts.UPGRADE_ACTIVE_STATES) + (consts.UPGRADE_STATE_FAILED,))}
            worst[0] = max(worst[0], len(disrupted))
            if len(disrupted) > cap:
                raise RuntimeError(f"{len(disrupted)} slices disrupted, over {FSM_BUDGET} ({cap})")
            return now

        def ledger():
            return ro.load_record(raw.get(consts.API_VERSION, consts.CLUSTER_POLICY_KIND, "cluster-policy"))

        def roll(what, done):
            t0 = time.perf_counter()
            for ticks in range(1, MAX_ROLLOUT_TICKS + 1):
                now = tick()
                if done(now):
                    return ticks, time.perf_counter() - t0
            raise RuntimeError(f"{what}: {MAX_ROLLOUT_TICKS} ticks, ledger {ledger()}")

        def settled(version, state):
            def done(now):
                rec_now = ledger()
                return ((state is None or (rec_now or {}).get("state") == state)
                        and all(lab.get(consts.DRIVER_VERSION_LABEL) == version
                                and lab.get(consts.UPGRADE_STATE_LABEL) not in pending for lab in now.values()))
            return done

        ticks, secs = roll("convergence", settled(ROLL_OLD, None))
        if ledger() is not None:
            raise RuntimeError(f"a roll was staged before any version edit: {ledger()}")
        log(f"rollout world: {len(nodes)} nodes in {len(slices)} slices of {FSM_SLICE_HOSTS} hosts on {ROLL_OLD} "
            f"after {ticks} ticks, {secs:.2f} s")

        # the clean roll
        driver_pod = next(p for p in raw.list("v1", "Pod", ns, field_selector={"spec.nodeName": card})
                          if p["metadata"]["labels"]["app"].startswith(consts.DRIVER_APP))["metadata"]
        testing.edit_clusterpolicy(raw, lambda cr: cr["spec"]["driver"].update(version=ROLL_NEW))
        synced()
        worst[0] = 0
        nums["clean_ticks"], nums["clean_s"] = roll("the clean roll", settled(ROLL_NEW, ro.STATE_COMPLETE))
        led = ledger()
        stats = rec.rollout.stats()
        status = raw.get(consts.API_VERSION, consts.CLUSTER_POLICY_KIND, "cluster-policy")["status"].get("rollout")
        prev = {n: (raw.get("v1", "Node", n)["metadata"].get("annotations") or {}).get(
            consts.UPGRADE_PREVIOUS_VERSION_ANNOTATION) for n in nodes}
        new = next(p for p in raw.list("v1", "Pod", ns, field_selector={"spec.nodeName": card})
                   if p["metadata"]["labels"]["app"] == driver_pod["labels"]["app"])["metadata"]
        ds = raw.get("apps/v1", "DaemonSet", driver_pod["labels"]["app"], ns)
        want_hash = ds["spec"]["template"]["metadata"]["annotations"][consts.LAST_APPLIED_HASH_ANNOTATION]
        misses = {
            "ledger": (led["kind"], led["state"], led["target"], led["previous"]) != (
                ro.KIND_DRIVER, ro.STATE_COMPLETE, ROLL_NEW, ROLL_OLD),
            "counts": (stats["promotions_total"], stats["pauses_total"], stats["rollbacks_total"]) != (2, 0, 0),
            "status": status != {"kind": ro.KIND_DRIVER, "target": ROLL_NEW, "state": ro.STATE_COMPLETE,
                                 "stage": "3/3", "previous": ROLL_OLD},
            "previous": set(prev.values()) != {ROLL_OLD},
            "driver pod": new["uid"] == driver_pod["uid"] or new["annotations"][
                consts.LAST_APPLIED_HASH_ANNOTATION] != want_hash,
            "card version": _labels_of(raw, card).get(consts.DRIVER_VERSION_LABEL) != ROLL_NEW,
        }
        if any(misses.values()):
            raise RuntimeError(f"clean roll: {[k for k, v in misses.items() if v]}; ledger {led}; stats {stats}; "
                               f"status.rollout {status}; previous versions {set(prev.values())}")
        nums["clean_worst_disrupted"] = worst[0]
        log(f"clean roll {ROLL_OLD} -> {ROLL_NEW}: complete in {nums['clean_ticks']} ticks, {nums['clean_s']:.2f} s, "
            f"{stats['promotions_total']} promotions, 0 pauses, 0 rollbacks; status.rollout {status}; the card's "
            f"{driver_pod['name']} recreated at {want_hash}; at most {worst[0]} of {len(slices)} slices disrupted "
            f"(cap {cap})")

        # the bad version, rolled back from its canary
        dumps0 = set(flight.RECORDER.dump_paths_snapshot())
        testing.inject_bad_version(ROLL_BAD, tflops_factor=0.5)
        try:
            testing.edit_clusterpolicy(raw, lambda cr: cr["spec"]["driver"].update(version=ROLL_BAD))
            synced()
            worst[0] = 0
            nums["bad_ticks"], nums["bad_s"] = roll("the bad roll", settled(ROLL_NEW, ro.STATE_ROLLED_BACK))
        finally:
            testing.clear_bad_versions()
        led = ledger()
        canary = [m for sid in (led.get("cohorts") or [[]])[0] for m in slices.get(sid, [sid])]
        # the FSM stamps a node's version at admission: the clean roll left
        # ROLL_OLD on every node, so a node stamped since joined this roll
        admitted = sorted(n for n in nodes if (raw.get("v1", "Node", n)["metadata"].get("annotations") or {}).get(
            consts.UPGRADE_PREVIOUS_VERSION_ANNOTATION) != ROLL_OLD)
        warnings = [e["message"] for e in raw.list("v1", "Event", ns) if e.get("reason") == "RolloutRolledBack"]
        dumps = [p for p in flight.RECORDER.dump_paths_snapshot() if p not in dumps0 and "rollout-rollback" in p]
        misses = {
            "ledger": (led["state"], led["target"], led["previous"]) != (ro.STATE_ROLLED_BACK, ROLL_BAD, ROLL_NEW),
            "evidence": not any("TFLOPS" in ev for ev in led.get("evidence") or []),
            "canary": len(canary) != FSM_SLICE_HOSTS or admitted != sorted(canary),
            "event": len(warnings) != 1 or "TFLOPS" not in warnings[0],
            "dump": len(dumps) != 1,
        }
        if any(misses.values()):
            raise RuntimeError(f"bad roll: {[k for k, v in misses.items() if v]}; ledger {led}; admitted "
                               f"{admitted} of canary {canary}; warnings {warnings}; dumps {dumps}")
        nums["bad_worst_disrupted"] = worst[0]
        log(f"bad roll {ROLL_NEW} -> {ROLL_BAD}: rolled back in {nums['bad_ticks']} ticks, {nums['bad_s']:.2f} s; "
            f"only the canary {led['cohorts'][0]} ({len(canary)} hosts) admitted, back on {ROLL_NEW}; "
            f"evidence {led['evidence'][:2]}; one Warning Event, one flight dump")
        return nums
    finally:
        _stop_controller(cached, stop, rec.ctrl if rec is not None else None, raw, namespace_env)


def phase_reconcilers() -> None:
    """The reconcilers on the card's node (phase 14). Part A: the card's
    node, one host of ``CARD_SLICE``, joins a 1000-node fleet of 4-host
    slices, single hosts of the other H100 variant and CPU nodes on one
    KubeSim, with the device plugin over the real cards advertising its
    capacity; ``run_reconcile_pass`` drives whole reconcile passes and the
    delta path. Part B: a 64-node world of 4-host slices on a second
    KubeSim; ``run_rollout`` stages a clean driver roll and a bad one."""
    from tpu_operator_torch import _build
    from tpu_operator_torch import consts
    from tpu_operator_torch.discovery import tfd
    from tpu_operator_torch.kube import kubesim, testing
    from tpu_operator_torch.native import gpuinfo
    from tpu_operator_torch.obs import flight
    from tpu_operator_torch.workloads.topology import device_generation

    t_phase = time.perf_counter()
    _build.reset_launches()
    n = torch.cuda.device_count()
    chips = gpuinfo.chip_summary()
    card_variant = device_generation(torch.cuda.get_device_name(0))
    if card_variant is None or len(chips) != n:
        raise RuntimeError(f"{torch.cuda.get_device_name(0)!r} is no H100 variant, or the chip table {chips}")
    ns = consts.DEFAULT_NAMESPACE
    faulthandler.dump_traceback_later(RECONCILERS_TIMEOUT_S, exit=True)
    flight_dir = flight.RECORDER.dir
    with tempfile.TemporaryDirectory(prefix="cs14-") as tmp:
        flight.RECORDER.dir = os.path.join(tmp, "flight")
        servers, kubelet, plugin_server = [], None, None
        try:
            labels = tfd.gather_features({"metadata": {"name": OPERANDS_NODE, "labels": {}}},
                                         dev_root="/dev", driver_root="/", env={}, chips=chips)
            check_features(labels, n)
            servers.append(kubesim.KubeSimServer(port=0).start())
            raw = kubesim.make_client(servers[0].port)
            testing.seed_cluster(raw, ns, node_names=())
            slices, nodes, cpus, _ = fsm_fleet(raw, servers[0].sim, OPERANDS_NODE, labels, card_variant,
                                               RECONCILE_SLICES, RECONCILE_SOLOS, RECONCILE_CPUS)
            kubelet, plugin_server, capacity = card_device_plugin(servers[0].port, tmp, chips)
            capacity(None)
            nums = run_reconcile_pass(servers[0].port, ns, servers[0].sim, OPERANDS_NODE, slices, nodes, cpus,
                                      capacity)
            plugin_server.stop()
            kubelet.stop()
            kubelet = plugin_server = None
            servers.pop().stop()

            servers.append(kubesim.KubeSimServer(port=0).start())
            raw = kubesim.make_client(servers[0].port)
            testing.seed_cluster(raw, ns, node_names=())
            unversioned = {k: v for k, v in labels.items() if k != consts.DRIVER_VERSION_LABEL}
            slices, nodes, _, _ = fsm_fleet(raw, servers[0].sim, OPERANDS_NODE, unversioned, card_variant,
                                            ROLLOUT_SLICES, 0, 0)
            servers[0].sim.set_node_chips(OPERANDS_NODE, n)
            nums.update(run_rollout(servers[0].port, ns, OPERANDS_NODE, slices, nodes))
        finally:
            if plugin_server is not None:
                plugin_server.stop()
            if kubelet is not None:
                kubelet.stop()
            for server in servers:
                server.stop()
            flight.RECORDER.dir = flight_dir
            faulthandler.cancel_dump_traceback_later()
    launched = {k: v for k, v in _build.launches.items() if v}
    if launched:
        raise RuntimeError(f"the reconcilers launched kernels of the package: {launched}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"reconcilers on: {smi.stdout.strip() or smi.stderr.strip()}; {json.dumps(nums)}; "
        f"no kernel of the package launched; phase 14 {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: the operator process on the card's node
# ---------------------------------------------------------------------------

OPERATOR_TIMEOUT_S = 600  # the phase's watchdog
OPERATOR_ONCE_NODES = (1, FSM_FLEET_NODES)  # --nodes of the shipped process's --once runs
FAILOVER_SLICES = 16  # 4-host slices of the failover world: 64 nodes
LEADER_LEASE_S = 3  # the leader Lease in the failover (the shipped 30 s would hold the phase)
SHARD_LEASE_S = 3  # GPU_SHARD_LEASE_S of the sharded replicas
STEADY_WINDOW_S = 2.0  # a window after READY that must issue no write
OPERATOR_WAIT_S = 120  # for a READY, a restore, a flip or a takeover
RESTORED_LABEL = "device-plugin"  # the deploy label deleted from the card's node
# the keys of the reference's shipped /debug/vars payload (its build_manager
# over a cached client: tpu_operator/main.py:364-413, manager.py:638-686)
DEBUG_VARS_KEYS = (
    "allocation", "apply_batches", "applyset", "delta_reconcile", "fault_tolerance", "flight", "informer_cache",
    "informer_drift_repairs", "informer_reads", "last_reconcile_ok", "queue_len", "reconcile_snapshot",
    "reconcilers", "remediation", "render_cache", "repartition", "rollout", "shards", "threads", "trace",
    "watchdog", "write_pipeline")


def _once(args: list) -> tuple:
    """``python -m tpu_operator_torch.main --kubesim --once`` with ``args``
    as a subprocess: ``(rc, seconds to exit, stderr)``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpu_operator_torch.main", "--kubesim", "--once",
                           "--metrics-port", "0", "--probe-port", "0", *args],
                          capture_output=True, text=True, timeout=OPERATOR_TIMEOUT_S)
    return proc.returncode, time.perf_counter() - t0, proc.stderr


def run_operator_process(n: int) -> dict:
    """Part A of phase 15: the shipped process. ``--simulate-kubelet``
    at each of ``OPERATOR_ONCE_NODES`` exits 0 (its wall time to exit is
    the port's ``time_to_ready_s``); without the kubelet it exits 2; with
    ``--grpc-kubelet`` it exits 0 and its node advertises the ``n`` cards
    NVML reports, whatever the stub devfs holds."""
    nums = {}
    for nodes in OPERATOR_ONCE_NODES:
        rc, secs, err = _once(["--simulate-kubelet", "--nodes", str(nodes)])
        if rc != 0 or "ready=True" not in err:
            raise RuntimeError(f"--once --nodes {nodes} exited {rc}:\n{err[-3000:]}")
        nums[f"time_to_ready_s_{nodes}"] = secs
    rc, secs, err = _once(["--nodes", "1"])
    if rc != 2 or "ready=False" not in err:
        raise RuntimeError(f"--once without the kubelet exited {rc}:\n{err[-3000:]}")
    nums["not_ready_s"] = secs
    rc, secs, err = _once(["--nodes", "1", "--grpc-kubelet", "--simulate-kubelet"])
    got = re.search(r"gRPC kubelet: node fake-gpu-node-1 allocatable nvidia\.com/gpu=(\S+)", err)
    if rc != 0 or got is None or got.group(1) != str(n):
        raise RuntimeError(f"--grpc-kubelet exited {rc} advertising {got and got.group(1)} of {n} cards:\n"
                           f"{err[-3000:]}")
    nums["grpc_kubelet_s"] = secs
    log(f"operator process: --once --simulate-kubelet exited 0 after "
        + ", ".join(f"{nums[f'time_to_ready_s_{k}']:.2f} s at {k} node{'s' * (k > 1)}" for k in OPERATOR_ONCE_NODES)
        + f" (time_to_ready_s); without the kubelet 2 after {nums['not_ready_s']:.2f} s; --grpc-kubelet 0 after "
          f"{secs:.2f} s with allocatable nvidia.com/gpu={n}, the card count")
    return nums


def _cr_status(raw) -> dict:
    from tpu_operator_torch import consts

    return raw.get(consts.API_VERSION, consts.CLUSTER_POLICY_KIND, "cluster-policy").get("status") or {}


def _degraded(raw) -> list:
    return (_cr_status(raw).get("slices") or {}).get("degraded") or []


def _settle(sim) -> float:
    """Seconds until a window of ``STEADY_WINDOW_S`` passes with no write
    request on ``sim``; raises after ``OPERATOR_WAIT_S``."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < OPERATOR_WAIT_S:
        writes = sim.writes_total()
        time.sleep(STEADY_WINDOW_S)
        if sim.writes_total() == writes:
            return time.perf_counter() - t0 - STEADY_WINDOW_S
    raise RuntimeError(f"no {STEADY_WINDOW_S} s window without a write within {OPERATOR_WAIT_S} s")


def run_operator_in_process(port: int, ns: str, sim, card: str, nodes: list, capacity) -> dict:
    """Part B of phase 15: the whole operator (``build_manager`` with its
    probe server and debug endpoints, ``wire_event_sources``, the manager's
    workers) through ``running_operator`` on the KubeSim at ``port``: READY;
    ``/healthz`` and ``/debug/vars``; a deploy label deleted from the card's
    node restored by a delta node pass through the workqueue and no full
    pass; every card unhealthy turns the card's slice not ready in
    ``status.slices`` and healthy again ready; a window with no write."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.kube import kubesim, testing

    raw = kubesim.make_client(port)
    probe = _free_port()
    nums = {}
    namespace_env = os.environ.get(consts.OPERATOR_NAMESPACE_ENV)
    os.environ[consts.OPERATOR_NAMESPACE_ENV] = ns
    try:
        t0 = time.perf_counter()
        with testing.running_operator(kubesim.make_client(port), ns, nodes, probe_port=probe,
                                      debug_endpoints=True) as mgr:
            _wait_for("READY with every slice ready", lambda: _cr_status(raw).get("state") == "ready" and (
                _cr_status(raw).get("slices") or {}).get("total") and not _degraded(raw), OPERATOR_WAIT_S)
            nums["ready_s"] = time.perf_counter() - t0
            healthz = _get(probe, "/healthz")
            debug = json.loads(_get(probe, "/debug/vars"))
            missing = sorted(set(DEBUG_VARS_KEYS) - set(debug))
            if healthz != "ok" or missing or debug["shards"] != {"enabled": False}:
                raise RuntimeError(f"/healthz {healthz!r}; /debug/vars lacks {missing}; shards {debug['shards']}")
            nums["settle_s"] = _settle(sim)

            key = consts.DEPLOY_LABEL_PREFIX + RESTORED_LABEL
            before = mgr.delta.stats()
            t0 = time.perf_counter()
            raw.patch_labels("v1", "Node", card, labels={key: None})
            _wait_for("the deploy label restored", lambda: _labels_of(raw, card).get(key) == "true", OPERATOR_WAIT_S)
            nums["label_restore_s"] = time.perf_counter() - t0
            after = mgr.delta.stats()
            if after["node_passes"] <= before["node_passes"] or after["full_passes"] != before["full_passes"]:
                raise RuntimeError(f"the label came back by node passes {before['node_passes']} -> "
                                   f"{after['node_passes']}, full passes {before['full_passes']} -> "
                                   f"{after['full_passes']}")

            t0 = time.perf_counter()
            capacity(0)
            _wait_for("the card's slice not ready", lambda: CARD_SLICE in _degraded(raw), OPERATOR_WAIT_S)
            nums["unhealthy_flip_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            capacity(None)
            _wait_for("the card's slice ready again", lambda: CARD_SLICE not in _degraded(raw), OPERATOR_WAIT_S)
            nums["healthy_flip_s"] = time.perf_counter() - t0
            flips = mgr.delta.stats()
            if flips["full_passes"] != before["full_passes"]:
                raise RuntimeError(f"the flips ran {flips['full_passes'] - before['full_passes']} full passes")
            w0 = sim.writes_total()
            time.sleep(STEADY_WINDOW_S)
            nums["steady_writes"] = sim.writes_total() - w0
            if nums["steady_writes"]:
                raise RuntimeError(f"a {STEADY_WINDOW_S} s window after the flips wrote {nums['steady_writes']}")
        log(f"operator in process: {len(nodes)} nodes READY in {nums['ready_s']:.2f} s; /healthz ok; /debug/vars "
            f"holds the reference's {len(DEBUG_VARS_KEYS)} keys, shards {{'enabled': False}}; no write in "
            f"{STEADY_WINDOW_S} s after {nums['settle_s']:.2f} s; {key} restored in {nums['label_restore_s']:.2f} s by "
            f"{after['node_passes'] - before['node_passes']} node pass(es), no full pass; every card unhealthy -> "
            f"{CARD_SLICE} not ready in {nums['unhealthy_flip_s']:.2f} s, healthy -> ready in "
            f"{nums['healthy_flip_s']:.2f} s, no full pass; then {STEADY_WINDOW_S} s without a write")
        return nums
    finally:
        if namespace_env is None:
            os.environ.pop(consts.OPERATOR_NAMESPACE_ENV, None)
        else:
            os.environ[consts.OPERATOR_NAMESPACE_ENV] = namespace_env


def run_failover(port: int, ns: str, nodes: list) -> dict:
    """Part C of phase 15, on the KubeSim at ``port``: two managers with
    leader election (``LEADER_LEASE_S``): the holder stops, the other
    takes ``gpu-operator-leader`` and runs a READY pass; then two sharded
    replicas (``GPU_SHARDS=2``, one shard each) split
    ``gpu-operator-shard-0/1``; the shard-0 holder stops without releasing
    its lease, and the survivor owns both, confirms the full pass live and
    runs it with the CR READY."""
    import threading

    from tpu_operator_torch import consts, main, shard
    from tpu_operator_torch.kube import kubesim, testing

    raw = kubesim.make_client(port)
    halt = threading.Event()
    running = []  # (manager, stop event)
    nums = {}
    saved = {k: os.environ.get(k) for k in (consts.OPERATOR_NAMESPACE_ENV, "GPU_SHARDS", "GPU_SHARD_MAX",
                                            "GPU_SHARD_LEASE_S")}
    os.environ[consts.OPERATOR_NAMESPACE_ENV] = ns

    def kubelet():
        while not halt.is_set():
            try:
                testing.simulate_kubelet_nodes(raw, ns, nodes)
            except Exception:  # noqa: BLE001  (races with the operators; retried next sweep)
                pass
            halt.wait(0.15)

    def replica(leader_election=False):
        client = kubesim.make_client(port)
        mgr, rec, _ = main.build_manager(client, ns, metrics_port=0, probe_port=0, leader_election=leader_election)
        mgr.lease_seconds = LEADER_LEASE_S
        stop = threading.Event()
        running.append((mgr, stop))
        main.wire_event_sources(mgr, client, ns, stop_event=stop)
        started = threading.Thread(target=mgr.start, daemon=True)  # a candidate's start waits for the lease
        started.start()
        return mgr, rec, started

    def lease(name):
        return raw.get_or_none("coordination.k8s.io/v1", "Lease", name, ns)

    def halt_replica(mgr):
        for m, stop in running:
            if m is mgr:
                stop.set()
        mgr.stop()

    threading.Thread(target=kubelet, daemon=True).start()
    try:
        a, rec_a, started_a = replica(leader_election=True)
        _wait_for("the first leader", lambda: not started_a.is_alive(), OPERATOR_WAIT_S)
        holder = lease("gpu-operator-leader")["spec"]["holderIdentity"]
        _wait_for("the leader's READY", lambda: rec_a.passes_total and _cr_status(raw).get("state") == "ready",
                  OPERATOR_WAIT_S)
        b, rec_b, started_b = replica(leader_election=True)
        time.sleep(1.0)
        if not started_b.is_alive() or rec_b.passes_total:
            raise RuntimeError("the second manager ran while the first held the lease")
        t0 = time.perf_counter()
        halt_replica(a)
        _wait_for("the candidate's lease", lambda: not started_b.is_alive(), OPERATOR_WAIT_S)
        nums["leader_takeover_s"] = time.perf_counter() - t0
        new = lease("gpu-operator-leader")["spec"]["holderIdentity"]
        _wait_for("the new leader's READY pass", lambda: rec_b.passes_total and _cr_status(raw).get(
            "state") == "ready", OPERATOR_WAIT_S)
        nums["leader_ready_s"] = time.perf_counter() - t0
        if new == holder:
            raise RuntimeError(f"gpu-operator-leader still names {holder}")
        halt_replica(b)

        os.environ.update(GPU_SHARDS="2", GPU_SHARD_MAX="1", GPU_SHARD_LEASE_S=str(SHARD_LEASE_S))
        a, rec_a, started_a = replica()
        _wait_for("replica A's start", lambda: not started_a.is_alive(), OPERATOR_WAIT_S)
        b, rec_b, started_b = replica()
        _wait_for("replica B's start", lambda: not started_b.is_alive(), OPERATOR_WAIT_S)
        sm_a, sm_b = a.shard_state, b.shard_state
        holders = {i: (lease(f"{shard.SHARD_LEASE_PREFIX}{i}") or {}).get("spec", {}).get("holderIdentity")
                   for i in (0, 1)}
        if (sm_a.owned(), sm_b.owned()) != ({0}, {1}) or holders != {0: sm_a.identity, 1: sm_b.identity}:
            raise RuntimeError(f"the replicas own {sm_a.owned()} and {sm_b.owned()}; the leases name {holders}")
        _wait_for("the sharded READY", lambda: rec_a.passes_total and _cr_status(raw).get("state") == "ready",
                  OPERATOR_WAIT_S)
        passes = rec_b.passes_total
        t0 = time.perf_counter()
        a.shard_lease_manager = None  # a crash: the lease is not released
        sm_a.stop(release=False)
        halt_replica(a)
        _wait_for("the survivor's shard 0", lambda: sm_b.owned() == {0, 1}, OPERATOR_WAIT_S)
        nums["shard_takeover_s"] = time.perf_counter() - t0
        if not sm_b.confirm_full_pass_owner():
            raise RuntimeError("the survivor could not confirm shard 0 live")
        _wait_for("the survivor's full pass", lambda: rec_b.passes_total > passes and _cr_status(raw).get(
            "state") == "ready", OPERATOR_WAIT_S)
        nums["shard_ready_s"] = time.perf_counter() - t0
        log(f"failover: {len(nodes)} nodes; the leader stopped, gpu-operator-leader ({LEADER_LEASE_S} s) taken "
            f"in {nums['leader_takeover_s']:.2f} s, READY pass at {nums['leader_ready_s']:.2f} s; GPU_SHARDS=2 "
            f"split {shard.SHARD_LEASE_PREFIX}0/1, the shard-0 holder stopped without a release, the survivor "
            f"owned both in {nums['shard_takeover_s']:.2f} s (lease {SHARD_LEASE_S} s), confirmed shard 0 live "
            f"and ran its full pass, READY at {nums['shard_ready_s']:.2f} s")
        return nums
    finally:
        halt.set()
        for mgr, stop in running:
            stop.set()
            mgr.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_operator() -> None:
    """The operator process on the card's node (phase 15). Part A: the
    shipped ``main --kubesim --once`` as subprocesses
    (``run_operator_process``). Part B: the card's node, one host of
    ``CARD_SLICE``, in a ``FSM_FLEET_NODES``-node fleet on one KubeSim with
    the device plugin over the real cards; the whole operator in process
    (``run_operator_in_process``). Part C: leader and shard failover on a
    second KubeSim of ``FAILOVER_SLICES`` 4-host slices (``run_failover``)."""
    from tpu_operator_torch import _build
    from tpu_operator_torch import consts
    from tpu_operator_torch.discovery import tfd
    from tpu_operator_torch.kube import kubesim, testing
    from tpu_operator_torch.native import gpuinfo
    from tpu_operator_torch.obs import flight
    from tpu_operator_torch.workloads.topology import device_generation

    t_phase = time.perf_counter()
    _build.reset_launches()
    n = torch.cuda.device_count()
    chips = gpuinfo.chip_summary()
    card_variant = device_generation(torch.cuda.get_device_name(0))
    if card_variant is None or len(chips) != n:
        raise RuntimeError(f"{torch.cuda.get_device_name(0)!r} is no H100 variant, or the chip table {chips}")
    ns = consts.DEFAULT_NAMESPACE
    faulthandler.dump_traceback_later(OPERATOR_TIMEOUT_S, exit=True)
    flight_dir = flight.RECORDER.dir
    with tempfile.TemporaryDirectory(prefix="cs15-") as tmp:
        flight.RECORDER.dir = os.path.join(tmp, "flight")
        servers, kubelet, plugin_server = [], None, None
        try:
            nums = run_operator_process(n)
            labels = tfd.gather_features({"metadata": {"name": OPERANDS_NODE, "labels": {}}},
                                         dev_root="/dev", driver_root="/", env={}, chips=chips)
            check_features(labels, n)
            servers.append(kubesim.KubeSimServer(port=0).start())
            raw = kubesim.make_client(servers[0].port)
            testing.seed_cluster(raw, ns, node_names=())
            _, nodes, _, _ = fsm_fleet(raw, servers[0].sim, OPERANDS_NODE, labels, card_variant)
            kubelet, plugin_server, capacity = card_device_plugin(servers[0].port, tmp, chips)
            capacity(None)
            nums.update(run_operator_in_process(servers[0].port, ns, servers[0].sim, OPERANDS_NODE, nodes, capacity))
            plugin_server.stop()
            kubelet.stop()
            kubelet = plugin_server = None
            servers.pop().stop()

            servers.append(kubesim.KubeSimServer(port=0).start())
            raw = kubesim.make_client(servers[0].port)
            testing.seed_cluster(raw, ns, node_names=())
            _, nodes, _, _ = fsm_fleet(raw, servers[0].sim, OPERANDS_NODE, labels, card_variant, FAILOVER_SLICES, 0, 0)
            servers[0].sim.set_node_chips(OPERANDS_NODE, n)
            nums.update(run_failover(servers[0].port, ns, nodes))
        finally:
            if plugin_server is not None:
                plugin_server.stop()
            if kubelet is not None:
                kubelet.stop()
            for server in servers:
                server.stop()
            flight.RECORDER.dir = flight_dir
            faulthandler.cancel_dump_traceback_later()
    launched = {k: v for k, v in _build.launches.items() if v}
    if launched:
        raise RuntimeError(f"the operator process launched kernels of the package: {launched}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"operator process on: {smi.stdout.strip() or smi.stderr.strip()}; {json.dumps(nums)}; "
        f"no kernel of the package launched; phase 15 {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 16: allocation churn and the chaos soak beside the card's node
# ---------------------------------------------------------------------------
CHURN_TIMEOUT_S = 420  # the phase's watchdog
CHURN_RATE = 1800.0  # allocations a minute (tests/scripts/alloc_churn.py --rate)
CHURN_WORKERS = 8
CHURN_GANG_FRACTION = 0.15
CHURN_GANG_HOSTS = 2
CHURN_SAMPLE_K = 64  # hosts a placement samples (the engine's default 16 draws the card's node, one in a thousand, too rarely)
CHURN_WINDOW_S = 20.0  # the churn's least wall time (the reference's floor is 45 s)
CHURN_HOLD_S = 8.0  # churn through the active remediation, as the reference's rig does
CHURN_WAIT_S = 180  # for READY, remediation active and the recovery
CHURN_VARIANT = "h100-nvl"  # the synthetic hosts: eight H100 NVL cards a host
CHURN_PRODUCT = "NVIDIA-H100-NVL"
CHURN_CARDS = {i: {"index": i, "nvlink_domain": i // 2} for i in range(8)}  # four NVLink-bridged pairs
SOAK = {"nodes": 12, "slice_pairs": 2, "seed": 5, "duration_s": 8.0, "bad_version_roll": True,
        "settle_timeout_s": 180.0}  # tests/test_chaos_soak.py's bad-version soak


class _CardStub:
    """The admission calls to the card's servicer, in process, each
    ``Allocate`` recorded: the ids asked for, the CDI names and env the
    answer gave, and whether the phase had marked the cards unhealthy."""

    def __init__(self, servicer):
        from tpu_operator_torch.kube.kubelet_sim import InProcessPluginStub

        self._stub = InProcessPluginStub(servicer)
        self.calls = []
        self.dead = False

    def GetDevicePluginOptions(self, request, timeout=None):
        return self._stub.GetDevicePluginOptions(request, timeout)

    def GetPreferredAllocation(self, request, timeout=None):
        return self._stub.GetPreferredAllocation(request, timeout)

    def Allocate(self, request, timeout=None):
        resp = self._stub.Allocate(request, timeout)
        c = resp.container_responses[0]
        self.calls.append({"ids": list(request.container_requests[0].devicesIDs),
                           "cdi": [d.name for d in c.cdi_devices], "env": dict(c.envs), "dead": self.dead})
        return resp


def _card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip() or smi.stderr.strip()


def _remediation_seen(raw) -> bool:
    rem = _cr_status(raw).get("remediation") or {}
    return rem.get("unhealthy", 0) + rem.get("quarantined", 0) >= 1


def run_alloc_churn(port: int, ns: str, sim, card: str, fleet: list, servicer, chips: list) -> dict:
    """Part A of phase 16, the port's copy of ``tests/scripts/alloc_churn.py``:
    the whole operator (``build_manager`` + ``wire_event_sources``, the
    kubelet sweep) over the KubeSim at ``port`` with ``fleet`` (the card's
    node and ``FLEET_NODES - 1`` synthetic H100 NVL hosts), and a
    ``ChurnEngine`` at the reference's traffic whose agent for the card's
    node runs over ``servicer``, the device plugin over the real cards.
    Churn from the start; at READY a card-death wave on the card's node
    (through its plugin) and one synthetic host (through KubeSim and its
    plugin); remediation active; churn on for ``CHURN_HOLD_S``; recovery
    and READY again; the churn lasts at least ``CHURN_WINDOW_S``."""
    import threading

    from tpu_operator_torch import consts
    from tpu_operator_torch.kube import kubesim, testing
    from tpu_operator_torch.kube.client import ConflictError, NotFoundError
    from tpu_operator_torch.kube.rest import TransientAPIError
    from tpu_operator_torch.main import CP_KEY, build_manager, wire_event_sources
    from tpu_operator_torch.native import gpuinfo
    from tpu_operator_torch.schedsim.engine import ChurnEngine

    raw = kubesim.make_client(port)
    testing.edit_clusterpolicy(raw, lambda cp: cp["spec"].update(remediation={
        "enabled": True, "maxAttempts": 3, "backoffSeconds": 0, "maxUnavailable": "50%",
        "systemicThreshold": "50%"}))
    roots = []
    real_summary = gpuinfo.chip_summary

    def summary(*args, **kw):
        roots.append(args[0] if args else kw.get("dev_root", "/dev"))
        return real_summary(*args, **kw)

    gpuinfo.chip_summary = summary
    nums = {}
    with contextlib.ExitStack() as stack:
        stack.callback(setattr, gpuinfo, "chip_summary", real_summary)
        mgr, _, _ = build_manager(kubesim.make_client(port), ns, metrics_port=0, probe_port=0)
        stop = threading.Event()
        wire_event_sources(mgr, kubesim.make_client(port), ns, stop_event=stop)
        mgr.start()
        stack.callback(mgr.stop)
        stack.callback(stop.set)
        halt = threading.Event()
        kube = kubesim.make_client(port)

        def kubelet():
            idle = 0.05
            while not halt.is_set():
                before = sim.request_counts.get("POST", 0) + sim.request_counts.get("PUT", 0)
                try:
                    testing.simulate_kubelet_nodes(kube, ns, fleet, halt_event=halt)
                except (ConflictError, NotFoundError, TransientAPIError, OSError):
                    pass  # races with the operator; the next sweep retries
                wrote = sim.request_counts.get("POST", 0) + sim.request_counts.get("PUT", 0) > before
                idle = 0.05 if wrote else min(idle * 2, 1.0)
                halt.wait(idle)

        sweeper = threading.Thread(target=kubelet, daemon=True)
        sweeper.start()
        stack.callback(sweeper.join, 30)
        stack.callback(halt.set)
        mgr.enqueue(CP_KEY)

        churn = kubesim.make_client(port)
        churn.GET_RETRY_BACKOFF_S = 0.05
        engine = ChurnEngine(churn, fleet, workers=CHURN_WORKERS, rate_per_min=CHURN_RATE,
                             gang_fraction=CHURN_GANG_FRACTION, gang_hosts=CHURN_GANG_HOSTS, sample_k=CHURN_SAMPLE_K,
                             seed=11, generation=CHURN_VARIANT, cards=CHURN_CARDS)
        agent = engine.host_agent(card, servicer)
        stub = agent.stub = _CardStub(servicer)
        engine.agents[card] = agent
        synthetic = [a for name, a in engine.agents.items() if name != card]
        opened = [c["path"] for a in synthetic for c in a.servicer.discover() if os.path.exists(os.path.dirname(c["path"]))]
        if opened:
            raise RuntimeError(f"synthetic hosts name device nodes that exist: {opened[:4]}")
        mgr.register_debug_vars("allocation", engine.stats)
        t0 = time.perf_counter()
        engine.start()
        stack.callback(engine.stop)

        _wait_for("READY under churn", lambda: _cr_status(raw).get("state") == "ready", CHURN_WAIT_S)
        nums["ready_before_s"] = time.perf_counter() - t0
        victim = fleet[1] if fleet[0] == card else fleet[0]
        engine.set_node_health(card, False)  # through the card's plugin: its kubelet writes 0 allocatable
        stub.dead = True
        sim.kill_node_chips(victim)
        engine.set_node_health(victim, False)
        t_wave = time.perf_counter()
        _wait_for("remediation active", lambda: _remediation_seen(raw), CHURN_WAIT_S)
        nums["remediation_active_s"] = time.perf_counter() - t_wave
        time.sleep(CHURN_HOLD_S)
        stub.dead = False
        engine.set_node_health(card, True)
        sim.restore_node_chips(victim)
        engine.set_node_health(victim, True)
        t_restore = time.perf_counter()
        _wait_for("READY again after the wave", lambda: _cr_status(raw).get("state") == "ready" and not (
            _cr_status(raw).get("remediation") or {}).get("quarantined", 0), CHURN_WAIT_S)
        nums["ready_after_s"] = time.perf_counter() - t_restore
        while time.perf_counter() - t0 < CHURN_WINDOW_S:
            time.sleep(0.5)
        engine.stop()
        nums["churn_wall_s"] = time.perf_counter() - t0
    verdict = engine.drain_check()
    stats = engine.stats()
    if verdict != {"chips_held": 0, "pods_holding": 0, "double_allocations": 0, "invariant_violations": 0}:
        raise RuntimeError(f"the churn's drain: {verdict}")
    if stats["partial_gang_violations"] or stats["errors_total"]:
        raise RuntimeError(f"partial gangs {stats['partial_gang_violations']}, errors {stats['errors_total']}")
    bad_roots = sorted({r for r in roots if r != servicer.dev_root})
    if bad_roots:
        raise RuntimeError(f"a host other than the card's asked for a chip table under {bad_roots}")
    minors = {str(c["index"]): c for c in chips}
    if not stub.calls:
        raise RuntimeError(f"no allocation landed on {card} in {stats['allocations_total']}")
    for call in stub.calls:
        want_cdi = [f"{consts.CDI_KIND}={i}" for i in call["ids"]]
        want_env = ",".join(minors[i]["uuid"] for i in call["ids"]) if set(call["ids"]) <= set(minors) else None
        if (call["dead"] or not set(call["ids"]) <= set(minors) or call["cdi"] != want_cdi
                or call["env"].get("NVIDIA_VISIBLE_DEVICES") != want_env):
            raise RuntimeError(f"an allocation on {card}: {call} (the card's minors {sorted(minors)})")
    nums.update({
        "allocations": stats["allocations_total"], "alloc_per_min": stats["alloc_per_min"],
        "alloc_p50_ms": stats["latency_ms"]["p50_ms"], "alloc_p99_ms": stats["latency_ms"]["p99_ms"],
        "gangs_admitted": stats["gangs"]["admitted"], "failures": stats["failures_total"],
        "fragmentation_pct": stats["fragmentation_pct"], "fragmentation_max_pct": stats["fragmentation_max_pct"],
        "card_allocations": len(stub.calls), "card_ids": sorted({i for c in stub.calls for i in c["ids"]}),
    })
    log(f"alloc churn on {_card_line()}: {len(fleet)} nodes, {stats['allocations_total']} allocations at {stats['alloc_per_min']}/min "
        f"(target {CHURN_RATE:.0f}), p50 {nums['alloc_p50_ms']} ms p99 {nums['alloc_p99_ms']} ms, "
        f"{nums['gangs_admitted']} gangs, fragmentation last {nums['fragmentation_pct']}% max "
        f"{nums['fragmentation_max_pct']}%; READY {nums['ready_before_s']:.2f} s under churn, remediation active "
        f"{nums['remediation_active_s']:.2f} s after the wave, READY {nums['ready_after_s']:.2f} s after recovery; "
        f"{len(stub.calls)} allocation(s) on {card} (cards {nums['card_ids']}), none while its cards were unhealthy; "
        f"drain 0 held, 0 double, 0 partial gangs; no synthetic host asked for a chip table")
    return nums


def run_soak() -> dict:
    """Part B of phase 16: ``tests/test_chaos_soak.py``'s bad-version soak
    (``SOAK``) under the port's lock-order watchdog, with every assertion
    of the reference's test."""
    from tpu_operator_torch.analysis import lockwatch
    from tpu_operator_torch.chaos.soak import SoakRunner

    lockwatch.reset()
    with lockwatch.watching(strict=False):
        report = SoakRunner(**SOAK).run()
        watched = lockwatch.stats()
    lockwatch.reset()
    brief = {k: v for k, v in report.items() if k not in ("trace", "alloc")}
    record = report.get("rollout_record") or {}
    kinds = {e["kind"] for e in report["trace"]["events"]}
    dumps = [p for p in report["flight_dumps"] if "rollout-rollback" in p]
    if not (report["converged_before_chaos"] and report["events_executed"] == len(report["trace"]["events"])
            and {"bad_version", "driver_roll"} <= kinds and report["settled"] and report["violations"] == []
            and report["ok"] and record.get("state") == "rolled-back" and record.get("evidence")
            and report["rollout"]["rollbacks_total"] >= 1 and len(report["rollout_nodes_admitted"]) <= 2
            and dumps and watched["cycles"] == 0):
        raise RuntimeError(f"the bad-version soak: {brief}; lockwatch {watched}")
    with open(dumps[0]) as f:
        decided = json.load(f)["ts"] - report["timings"]["driver_roll_at"]
    nums = {**{f"soak_{k}": v for k, v in report["timings"].items() if k != "driver_roll_at"},
            "soak_rollback_after_roll_s": decided, "soak_events": report["events_executed"],
            "soak_admitted": report["rollout_nodes_admitted"],
            "soak_rolled_back": sorted(report["rollout_nodes_rolled_back"]),
            "soak_allocations": report["alloc"]["allocations_total"],
            "lockwatch_blocking": watched["blocking_events"], "lockwatch_cycles": watched["cycles"]}
    log(f"chaos soak on {_card_line()}: converged {nums['soak_converge_s']:.2f} s, {nums['soak_events']} events in "
        f"{nums['soak_chaos_s']:.2f} s, rollback decided {decided:.2f} s after the driver roll, settled "
        f"{nums['soak_settle_s']:.2f} s after the chaos; admitted by the roll {nums['soak_admitted']}, rolled back "
        f"after coming up on the bad driver {report['rollout_nodes_rolled_back']}; {nums['soak_allocations']} "
        f"allocations; lockwatch {watched['cycles']} cycles, {watched['blocking_events']} held across blocking, "
        f"{watched['locks_created']} locks")
    return nums


def phase_churn() -> None:
    """Allocation churn and the chaos soak beside the card's node (phase
    16). Part A: ``run_alloc_churn`` on a KubeSim of ``FLEET_NODES`` nodes,
    the card's (its device plugin over the real cards) and synthetic H100
    NVL hosts. Part B: ``run_soak``."""
    from tpu_operator_torch import _build
    from tpu_operator_torch import consts
    from tpu_operator_torch.discovery import tfd
    from tpu_operator_torch.kube import kubesim, testing
    from tpu_operator_torch.native import gpuinfo
    from tpu_operator_torch.obs import flight

    t_phase = time.perf_counter()
    _build.reset_launches()
    n = torch.cuda.device_count()
    chips = gpuinfo.chip_summary()
    if len(chips) != n:
        raise RuntimeError(f"the chip table {chips} holds not the {n} cards torch sees")
    ns = consts.DEFAULT_NAMESPACE
    faulthandler.dump_traceback_later(CHURN_TIMEOUT_S, exit=True)
    flight_dir = flight.RECORDER.dir
    namespace_env = os.environ.get(consts.OPERATOR_NAMESPACE_ENV)
    os.environ[consts.OPERATOR_NAMESPACE_ENV] = ns
    with tempfile.TemporaryDirectory(prefix="cs16-") as tmp:
        flight.RECORDER.dir = os.path.join(tmp, "flight")
        flight.RECORDER.clear()  # no dump of an earlier phase rate-limits this phase's
        server, kubelet, plugin_server = None, None, None
        try:
            labels = tfd.gather_features({"metadata": {"name": OPERANDS_NODE, "labels": {}}},
                                         dev_root="/dev", driver_root="/", env={}, chips=chips)
            check_features(labels, n)
            server = kubesim.KubeSimServer(port=0).start()
            raw = kubesim.make_client(server.port)
            testing.seed_cluster(raw, ns, node_names=())
            raw.create({"apiVersion": "v1", "kind": "Node", "metadata": {
                "name": OPERANDS_NODE, "labels": {**labels, "kubernetes.io/hostname": OPERANDS_NODE}}})
            fleet = [OPERANDS_NODE] + server.sim.add_nodes(
                FLEET_NODES - 1, name_prefix="fleet", template=testing.make_gpu_node(
                    "x", variant=CHURN_VARIANT, product=CHURN_PRODUCT))
            kubelet, plugin_server, capacity = card_device_plugin(server.port, tmp, chips)
            capacity(None)
            nums = run_alloc_churn(server.port, ns, server.sim, OPERANDS_NODE, fleet, plugin_server.servicer, chips)
            plugin_server.stop()
            kubelet.stop()
            kubelet = plugin_server = None
            server.stop()
            server = None
            nums.update(run_soak())
        finally:
            if plugin_server is not None:
                plugin_server.stop()
            if kubelet is not None:
                kubelet.stop()
            if server is not None:
                server.stop()
            flight.RECORDER.dir = flight_dir
            if namespace_env is None:
                os.environ.pop(consts.OPERATOR_NAMESPACE_ENV, None)
            else:
                os.environ[consts.OPERATOR_NAMESPACE_ENV] = namespace_env
            faulthandler.cancel_dump_traceback_later()
    launched = {k: v for k, v in _build.launches.items() if v}
    if launched:
        raise RuntimeError(f"the churn and the soak launched kernels of the package: {launched}")
    log(f"churn and soak on: {_card_line()}; {json.dumps(nums)}; "
        f"no kernel of the package launched; phase 16 {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: the static analyser and the two e2e drivers on the card's machine
# ---------------------------------------------------------------------------
LINT_E2E_TIMEOUT_S = 400  # the phase's watchdog
E2E_TIMEOUT_S = 300  # for the HTTP driver's subprocess, as its CPU test allows
SEEDED_GUARDED_BY = """\
import threading


class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []

    def add(self, x):
        with self._lock:
            self._items.append(x)

    def bad(self, x):
        self._items.append(x)
"""  # tests/test_analysis.py's guarded-by fixture: one finding, at line 14


def _lint(root: str, cwd: str) -> tuple:
    """``python -m tpu_operator_torch.analysis --repo-root root``:
    (rc, stdout, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpu_operator_torch.analysis", "--repo-root", root],
                          capture_output=True, text=True, timeout=300, cwd=cwd)
    return proc.returncode, proc.stdout + proc.stderr, time.perf_counter() - t0


def check_lint(root: str) -> dict:
    """The port's analyser over the tree the script runs from: 0 findings
    and rc 0 twice, byte-identical; the scan alone timed in process; a
    seeded guarded-by violation in a temporary root with its own
    ``[tool.gpu_analysis]`` section gives rc 1 and names it."""
    from tpu_operator_torch.analysis.config import load_config
    from tpu_operator_torch.analysis.engine import run_analysis

    runs = [_lint(root, root) for _ in range(2)]
    for rc, out, _ in runs:
        if rc != 0 or "0 finding(s)" not in out:
            raise RuntimeError(f"the port's lint over its tree: rc={rc}\n{out[-3000:]}")
    if runs[0][1] != runs[1][1]:
        raise RuntimeError(f"two lint runs differ:\n{runs[0][1]}\n---\n{runs[1][1]}")
    t0 = time.perf_counter()
    report = run_analysis(load_config(root))
    scan_ms = (time.perf_counter() - t0) * 1e3
    if report.new or report.findings:
        raise RuntimeError(f"the in-process scan found {report.render_text()}")
    with tempfile.TemporaryDirectory(prefix="cs17-lint-") as tmp:
        with open(os.path.join(tmp, "pyproject.toml"), "w") as f:
            f.write('[tool.gpu_analysis]\npaths = ["pkg"]\nbaseline = "bl.json"\n')
        os.makedirs(os.path.join(tmp, "pkg"))
        with open(os.path.join(tmp, "pkg", "mod.py"), "w") as f:
            f.write(SEEDED_GUARDED_BY)
        rc, out, _ = _lint(tmp, root)
    if rc != 1 or "pkg/mod.py:14: [guarded-by]" not in out or "1 finding(s)" not in out:
        raise RuntimeError(f"the seeded guarded-by violation: rc={rc}\n{out[-3000:]}")
    nums = {"lint_files": report.files_scanned, "lint_suppressed": report.suppressed,
            "lint_scan_ms": scan_ms, "lint_cli_s": [runs[0][2], runs[1][2]]}
    log(f"lint: {runs[0][1].strip()}; two runs byte-identical; the scan {scan_ms:.1f} ms in process, "
        f"the CLI {runs[0][2]:.2f} s and {runs[1][2]:.2f} s; the seeded guarded-by violation rc 1")
    return nums


def check_http_e2e(root: str, ns: str) -> float:
    """``python -m tpu_operator_torch.e2e.http_e2e`` as a subprocess:
    rc 0, ``HTTP-E2E PASSED`` and the maintenance window held; its wall
    seconds."""
    env = dict(os.environ, OPERATOR_NAMESPACE=ns, UNIT_TEST="true")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpu_operator_torch.e2e.http_e2e"], env=env,
                          capture_output=True, text=True, timeout=E2E_TIMEOUT_S, cwd=root)
    wall = time.perf_counter() - t0
    steps = [line for line in proc.stdout.splitlines() if line.startswith("=== ")]
    if (proc.returncode != 0 or "HTTP-E2E PASSED" not in proc.stdout
            or "ok: maintenance window" not in proc.stdout):
        raise RuntimeError(f"http_e2e rc={proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    log(f"http_e2e: rc 0, HTTP-E2E PASSED in {wall:.2f} s, {len(steps)} steps "
        f"(gpu-maintenance-handler's window held over the wire)")
    return wall


def check_fake_e2e() -> float:
    """``e2e.fake_e2e.main()`` with its probes on the cards over NCCL: 0,
    and each probe's ``*-ready`` file ok for every card; its wall seconds."""
    from tpu_operator_torch.e2e import fake_e2e

    n = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="cs17-probes-") as probe_dir:
        t0 = time.perf_counter()
        rc = fake_e2e.main(probe_dir=probe_dir)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"fake_e2e.main() returned {rc}")
        ready = {}
        for component in fake_e2e.PROBES:
            with open(os.path.join(probe_dir, f"{component}-ready")) as f:
                payload = json.load(f)
            width = payload.get("n_devices", payload.get("n_stages", payload.get("n_experts")))
            if payload.get("ok") is not True or width != n:
                raise RuntimeError(f"{component}-ready: {payload} (expected ok over {n} cards)")
            ready[component] = width
    log(f"fake_e2e: rc 0 in {wall:.2f} s; probes on the cards over NCCL, ready files {json.dumps(ready)}")
    return wall


def phase_lint_e2e() -> None:
    """The static analyser and the two e2e drivers on the card's machine
    (phase 17): ``check_lint``, ``check_http_e2e``, ``check_fake_e2e``."""
    from tpu_operator_torch import _build
    from tpu_operator_torch import consts

    t_phase = time.perf_counter()
    _build.reset_launches()
    root = os.path.dirname(os.path.abspath(__file__))
    ns = consts.DEFAULT_NAMESPACE
    namespace_env = os.environ.get(consts.OPERATOR_NAMESPACE_ENV)
    unit_test_env = os.environ.get("UNIT_TEST")
    faulthandler.dump_traceback_later(LINT_E2E_TIMEOUT_S, exit=True)
    try:
        nums = check_lint(root)
        nums["http_e2e_s"] = check_http_e2e(root, ns)
        os.environ[consts.OPERATOR_NAMESPACE_ENV] = ns
        nums["fake_e2e_s"] = check_fake_e2e()
    finally:
        faulthandler.cancel_dump_traceback_later()
        for key, value in ((consts.OPERATOR_NAMESPACE_ENV, namespace_env), ("UNIT_TEST", unit_test_env)):
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    launched = {k: v for k, v in _build.launches.items() if v}
    if launched:
        raise RuntimeError(f"the analyser and the e2e drivers launched kernels of the package: {launched}")
    log(f"lint and e2e on: {_card_line()}; {json.dumps(nums)}; "
        f"no kernel of the package launched; phase 17 {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 18: the reference's fault, remediation, slice, chaos and alert-rule
# suites with the card's node in the fleet
# ---------------------------------------------------------------------------
RESILIENCE_TIMEOUT_S = 600  # the phase's watchdog
RESILIENCE_WAIT_S = 90  # for a convergence, a quarantine or a recovery
RES_FLEET = ("res-node-1", "res-node-2", "res-node-3")  # synthetic HGX H100 hosts beside the card's node
RES_SLICE = "res-slice"  # the card's node and RES_FLEET as one 4-host slice
# tests/test_fault_matrix.py's write-verb matrix: (verb, fault)
WRITE_VERB_FAULTS = (
    ("POST", {"code": 500, "count": 2}), ("POST", {"code": 429, "retry_after": 0.05, "count": 2}),
    ("PUT", {"code": 503, "count": 2}), ("PUT", {"code": 429, "retry_after": 0.05, "count": 1}),
    ("PUT", {"latency_s": 0.15, "count": 2}), ("APPLY", {"code": 429, "retry_after": 0.05, "count": 2}),
    ("APPLY", {"code": 500, "count": 1}), ("APPLY", {"code": 503, "count": 1}),
    ("APPLY", {"latency_s": 0.15, "count": 2}), ("LIST", {"code": 500, "count": 2}),
)
REMEDIATION = {"enabled": True, "maxAttempts": 2, "backoffSeconds": 0, "maxUnavailable": "50%",
               "systemicThreshold": "50%"}
CHAOS_SEED = 20260730  # tests/test_chaos_kubesim.py's
CHAOS_CHURN_S = 12.0
CHAOS_MAX_NODES = 24


def _tune_client(client):
    """``tests/test_fault_matrix.py``'s cadence for the same retry policy
    and breaker."""
    client.retry_policy.backoff_s = 0.02
    client.retry_policy.cap_s = 0.2
    client.retry_policy.budget_s = 5.0
    client.breaker.cooldown_base_s = 0.2
    client.breaker.cooldown_cap_s = 0.5
    return client


@contextlib.contextmanager
def _card_fleet(tmp: str, chips: list, card_labels: dict, fleet=RES_FLEET, fleet_labels=None):
    """A KubeSim seeded with the port's CRD and sample, the card's node
    (``card_labels``; its device plugin over the real cards, every card
    advertised) and the synthetic hosts ``fleet`` (8 cards each, through
    KubeSim, with ``fleet_labels(i)``). Yields ``(server, raw, capacity,
    servicer)``; everything started stops on exit."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.kube import kubesim, testing

    server = kubesim.KubeSimServer(kubesim.KubeSim(bookmark_interval_s=1.0)).start()
    kubelet = plugin_server = None
    try:
        raw = kubesim.make_client(server.port)
        testing.seed_cluster(raw, consts.DEFAULT_NAMESPACE, node_names=())
        raw.create({"apiVersion": "v1", "kind": "Node", "metadata": {
            "name": OPERANDS_NODE, "labels": {**card_labels, "kubernetes.io/hostname": OPERANDS_NODE}}})
        for i, name in enumerate(fleet):
            raw.create(testing.make_gpu_node(name, extra_labels=fleet_labels(i) if fleet_labels else None))
            server.sim.set_node_chips(name, testing.HOST_CARDS)
        kubelet, plugin_server, capacity = card_device_plugin(server.port, tmp, chips)
        capacity(None)
        yield server, raw, capacity, plugin_server.servicer
    finally:
        if plugin_server is not None:
            plugin_server.stop()
        if kubelet is not None:
            kubelet.stop()
        server.stop()


def _node_fence(raw, name: str) -> tuple:
    """(remediation state, cordoned, repair-tainted) of a node."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.kube.client import has_taint

    node = raw.get("v1", "Node", name)
    return ((node["metadata"].get("labels") or {}).get(consts.REMEDIATION_STATE_LABEL),
            bool((node.get("spec") or {}).get("unschedulable")), has_taint(node, consts.REPAIR_TAINT_KEY))


def _quarantined(raw, name: str) -> bool:
    from tpu_operator_torch import consts

    return _node_fence(raw, name) == (consts.REMEDIATION_STATE_QUARANTINED, True, True)


def _clean(raw, name: str) -> bool:
    from tpu_operator_torch import consts

    return _node_fence(raw, name) == (None, False, False) and consts.REPAIR_LABEL not in _labels_of(raw, name)


def _event(raw, reason: str, *needles) -> bool:
    from tpu_operator_torch import consts

    return any(e.get("reason") == reason and all(n in e.get("message", "") for n in needles)
               for e in raw.list("v1", "Event", consts.DEFAULT_NAMESPACE))


def _enable_remediation(raw, **knobs) -> None:
    from tpu_operator_torch.kube import testing

    testing.edit_clusterpolicy(raw, lambda cp: cp["spec"].update(remediation={**REMEDIATION, **knobs}))


def _operand_pods(raw, node: str) -> dict:
    """The card node's operand pods: name -> uid."""
    from tpu_operator_torch import consts

    return {p["metadata"]["name"]: p["metadata"].get("uid") for p in raw.list("v1", "Pod", consts.DEFAULT_NAMESPACE)
            if p["spec"].get("nodeName") == node
            and (p["metadata"].get("labels") or {}).get("app", "").startswith(consts.OPERAND_APP_PREFIX)}


def run_fault_matrix(tmp: str, chips: list, labels: dict) -> dict:
    """``tests/test_fault_matrix.py`` with the card's node in the fleet: the
    write-verb matrix brings the CR to READY (every fault consumed, APPLY's
    retries counted under its name, a faulted DELETE converging), the card's
    node labelled and advertising every card; a 1 s partition trips the
    breaker, which closes, and a spec edit after it lands; a state whose
    control raises leaves the other states' DaemonSets in place under
    Degraded, which lifts when the fault clears."""
    import yaml

    from tpu_operator_torch import consts
    from tpu_operator_torch.controllers import object_controls, state_manager
    from tpu_operator_torch.controllers.clusterpolicy_controller import ClusterPolicyReconciler
    from tpu_operator_torch.kube import client as kclient
    from tpu_operator_torch.kube import kubesim, rest, testing

    ns = consts.DEFAULT_NAMESPACE
    n = len(chips)
    nodes = [OPERANDS_NODE, *RES_FLEET]
    exporter = consts.OPERAND_APPS["tpu-metrics-exporter"]
    nums = {}
    with _card_fleet(os.path.join(tmp, "faults"), chips, labels) as (server, raw, _, _):
        sim = server.sim
        client = _tune_client(kubesim.make_client(server.port))
        for verb, fault in WRITE_VERB_FAULTS:
            sim.inject_fault(verb, "*", **fault)
        t0 = time.perf_counter()
        with testing.running_operator(client, ns, nodes) as mgr:
            _wait_for("READY through the write-verb matrix", lambda: _cr_status(raw).get("state") == "ready",
                      RESILIENCE_WAIT_S)
            nums["fault_ready_s"] = time.perf_counter() - t0
            _wait_for("every injected fault consumed", lambda: sim.faults_pending() == 0, RESILIENCE_WAIT_S)
            retry = client.fault_stats()["retry"]
            card = _labels_of(raw, OPERANDS_NODE)
            caps = node_caps(raw, OPERANDS_NODE)
            if not (retry["retries_total"] and retry["retry_after_honored"] and retry["retries_by_verb"].get("APPLY")
                    and card.get(consts.TPU_PRESENT_LABEL) == "true" and caps == (str(n), str(n))):
                raise RuntimeError(f"the write-verb matrix: retries {retry}; card labels {card}; capacity and "
                                   f"allocatable {caps}")
            sim.inject_fault("DELETE", "*", code=500, count=1)
            testing.edit_clusterpolicy(raw, lambda cp: cp["spec"]["metricsExporter"].update(enabled=False))
            _wait_for("the faulted DELETE converged", lambda: raw.get_or_none("apps/v1", "DaemonSet", exporter, ns)
                      is None and sim.faults_pending() == 0, RESILIENCE_WAIT_S)

            trips = client.fault_stats()["breaker"]["trips_total"]
            sim.partition(1.0)
            time.sleep(1.2)
            t0 = time.perf_counter()

            def edit_lands():
                try:
                    testing.edit_clusterpolicy(client, lambda cp: cp["spec"]["metricsExporter"].update(enabled=True))
                    return True
                except (rest.TransientAPIError, OSError):
                    return False

            _wait_for("a spec edit after the partition", edit_lands, RESILIENCE_WAIT_S)
            _wait_for("READY again after the partition", lambda: raw.get_or_none(
                "apps/v1", "DaemonSet", exporter, ns) is not None and _cr_status(raw).get("state") == "ready",
                RESILIENCE_WAIT_S)
            nums["partition_recover_s"] = time.perf_counter() - t0
            breaker = client.fault_stats()["breaker"]
            if not (sim.partition_rejects and breaker["trips_total"] > trips and breaker["state"] != "open"
                    and mgr.healthy()):
                raise RuntimeError(f"the partition: {sim.partition_rejects} rejects, breaker {breaker}")
            mgr.enqueue("clusterpolicy")
            _wait_for("a pass after the matrix", lambda: mgr._last_reconcile_ok, RESILIENCE_WAIT_S)
        card_node = raw.get("v1", "Node", OPERANDS_NODE, copy=True)

    fake = kclient.FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": ns}}, card_node])
    with open(testing.sample_clusterpolicy_path()) as f:
        fake.create(yaml.safe_load(f))
    assets = (state_manager.DEFAULT_ASSETS_DIR if os.path.isdir(state_manager.DEFAULT_ASSETS_DIR)
              else state_manager.PACKAGE_ASSETS_DIR)
    rec = ClusterPolicyReconciler(fake, assets_dir=assets)
    real = object_controls.CONTROLS["daemonset"]

    def exploding(ctrl, state, obj):
        if state == "state-device-plugin":
            raise RuntimeError("injected control failure")
        return real(ctrl, state, obj)

    object_controls.CONTROLS["daemonset"] = exploding
    try:
        requeued = rec.reconcile().requeue_after is not None
    finally:
        object_controls.CONTROLS["daemonset"] = real
    status = fake.get(consts.API_VERSION, consts.CLUSTER_POLICY_KIND, "cluster-policy")["status"]
    degraded = {c["type"]: c for c in status["conditions"]}["Degraded"]
    names = {d["metadata"]["name"] for d in fake.list("apps/v1", "DaemonSet", ns)}
    if not (requeued and [e["state"] for e in status.get("erroredStates", [])] == ["state-device-plugin"]
            and degraded["status"] == "True" and "state-device-plugin" in degraded["message"]
            and consts.OPERAND_APPS["tpu-feature-discovery"] in names and consts.DRIVER_APP in names
            and consts.OPERAND_APPS["tpu-device-plugin-daemonset"] not in names):
        raise RuntimeError(f"the raising state: {status.get('erroredStates')}; {degraded}; DaemonSets {sorted(names)}")
    rec.reconcile()
    status = fake.get(consts.API_VERSION, consts.CLUSTER_POLICY_KIND, "cluster-policy")["status"]
    if "erroredStates" in status or {c["type"]: c for c in status["conditions"]}["Degraded"]["status"] != "False":
        raise RuntimeError(f"Degraded did not lift with the fault cleared: {status}")
    log(f"fault matrix with the card's node: READY through {len(WRITE_VERB_FAULTS)} write-verb rows in "
        f"{nums['fault_ready_s']:.2f} s, the card's node labelled with capacity and allocatable {n}; the partition's "
        f"breaker closed and READY again {nums['partition_recover_s']:.2f} s after it; the raising state isolated "
        f"under Degraded with {len(names)} DaemonSets in place")
    return nums


def run_remediation_matrix(tmp: str, chips: list, labels: dict) -> dict:
    """``tests/test_remediation_matrix.py`` with the card's node in the
    fleet. World 1: every card unhealthy through its servicer quarantines
    the card's node (cordon, taint, label) after restarting its ``gpu-*``
    operand pods, no other node touched; the cards back recover it; then a
    synthetic host flaps to ``exhausted``. World 2: the card and one
    synthetic host dead before remediation turns on (half the fleet) open
    the breaker with zero disruptions; the host back closes it and the
    card's node is quarantined. World 3: a crash-looping operand pod on the
    card's node is restarted without quarantine."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.kube import kubesim, testing

    ns = consts.DEFAULT_NAMESPACE
    nodes = [OPERANDS_NODE, *RES_FLEET]
    nums = {}
    wait = RESILIENCE_WAIT_S
    with _card_fleet(os.path.join(tmp, "rm1"), chips, labels) as (server, raw, capacity, _):
        sim = server.sim
        with testing.running_operator(kubesim.make_client(server.port), ns, nodes):
            _wait_for("READY", lambda: _cr_status(raw).get("state") == "ready", wait)
            _enable_remediation(raw)
            before = _operand_pods(raw, OPERANDS_NODE)
            t0 = time.perf_counter()
            capacity(0)
            _wait_for("the card's node quarantined", lambda: _quarantined(raw, OPERANDS_NODE), wait)
            nums["quarantine_s"] = time.perf_counter() - t0
            after = _operand_pods(raw, OPERANDS_NODE)
            restarted = sorted(p for p, uid in before.items() if after.get(p) != uid)
            touched = [m for m in RES_FLEET if not _clean(raw, m)]
            if not restarted or touched or not _event(raw, "NodeQuarantined", OPERANDS_NODE):
                raise RuntimeError(f"quarantine: operand pods restarted {restarted} of {sorted(before)}; other nodes "
                                   f"touched {touched}")
            t0 = time.perf_counter()
            capacity(None)
            _wait_for("the card's node recovered", lambda: _clean(raw, OPERANDS_NODE), wait)
            nums["recovery_s"] = time.perf_counter() - t0
            if not _event(raw, "NodeRemediationRecovered", OPERANDS_NODE):
                raise RuntimeError("no NodeRemediationRecovered Event names the card's node")
            victim = RES_FLEET[0]
            sim.kill_node_chips(victim)
            _wait_for("the flapping host quarantined", lambda: _quarantined(raw, victim), wait)
            sim.flap_node_chips(victim)
            _wait_for("the flapping host recovered", lambda: _clean(raw, victim), wait)
            sim.flap_node_chips(victim)
            _wait_for("the flapping host exhausted", lambda: _node_fence(raw, victim) == (
                consts.REMEDIATION_STATE_EXHAUSTED, True, True), wait)
            sim.restore_node_chips(victim)
            time.sleep(2.0)
            if _node_fence(raw, victim) != (consts.REMEDIATION_STATE_EXHAUSTED, True, True) or not _event(
                    raw, "NodeRemediationExhausted", victim):
                raise RuntimeError(f"exhausted is not sticky: {_node_fence(raw, victim)}")

    with _card_fleet(os.path.join(tmp, "rm2"), chips, labels) as (server, raw, capacity, _):
        sim = server.sim
        with testing.running_operator(kubesim.make_client(server.port), ns, nodes):
            _wait_for("READY", lambda: _cr_status(raw).get("state") == "ready", wait)
            raw.create({"apiVersion": "v1", "kind": "Pod", "metadata": {
                "name": "train-1", "namespace": "default", "labels": {"job": "train"},
                "ownerReferences": [{"kind": "Job", "name": "train", "uid": "j1"}]},
                "spec": {"nodeName": OPERANDS_NODE, "containers": [
                    {"name": "train", "resources": {"limits": {consts.GPU_RESOURCE: "1"}}}]},
                "status": {"phase": "Running"}})
            capacity(0)
            sim.kill_node_chips(RES_FLEET[0])
            t0 = time.perf_counter()
            _enable_remediation(raw)
            _wait_for("the systemic breaker open", lambda: (_cr_status(raw).get("remediation") or {}).get(
                "breakerOpen") is True, wait)
            nums["breaker_open_s"] = time.perf_counter() - t0
            degraded = {c["type"]: c for c in _cr_status(raw).get("conditions") or []}["Degraded"]
            time.sleep(2.0)
            disrupted = [m for m in nodes if _node_fence(raw, m) != (None, False, False)]
            if (degraded["status"], degraded["reason"]) != ("True", "SystemicNodeFailure") or disrupted or not (
                    _event(raw, "SystemicNodeFailure")
                    and raw.get_or_none("v1", "Pod", "train-1", "default") is not None):
                raise RuntimeError(f"the systemic breaker: {degraded}; disrupted {disrupted}")
            sim.restore_node_chips(RES_FLEET[0])
            _wait_for("the card's node quarantined once the breaker closed", lambda: _quarantined(
                raw, OPERANDS_NODE), 2 * wait)
            if (_cr_status(raw).get("remediation") or {}).get("breakerOpen"):
                raise RuntimeError("the breaker stayed open")

    with _card_fleet(os.path.join(tmp, "rm3"), chips, labels) as (server, raw, _, _):
        with testing.running_operator(kubesim.make_client(server.port), ns, nodes):
            _wait_for("READY", lambda: _cr_status(raw).get("state") == "ready", wait)
            _enable_remediation(raw, backoffSeconds=1)
            app = consts.OPERAND_APPS["tpu-device-plugin-daemonset"]
            pod = next(p for p in raw.list("v1", "Pod", ns) if p["spec"].get("nodeName") == OPERANDS_NODE
                       and (p["metadata"].get("labels") or {}).get("app") == app)
            name = pod["metadata"]["name"]
            t0 = time.perf_counter()
            server.sim.crashloop_pod(ns, name)
            _wait_for("the crash-looping operand restarted", lambda: ((raw.get_or_none("v1", "Pod", name, ns) or {})
                      .get("status") or {}).get("containerStatuses") == [{"ready": True}], wait)
            _wait_for("the card's node clean", lambda: _clean(raw, OPERANDS_NODE), wait)
            nums["crashloop_fixed_s"] = time.perf_counter() - t0
            if _node_fence(raw, OPERANDS_NODE) != (None, False, False):
                raise RuntimeError(f"the crash loop fenced the card's node: {_node_fence(raw, OPERANDS_NODE)}")
    log(f"remediation matrix on the card's node: quarantined in {nums['quarantine_s']:.2f} s ({len(restarted)} of "
        f"{len(before)} operand pods restarted, no other node touched), recovered in {nums['recovery_s']:.2f} s; a flapping "
        f"host exhausted; half the fleet dead opened the breaker in {nums['breaker_open_s']:.2f} s with 0 "
        f"disruptions, the card's node quarantined once it closed; a crash-looping {app} pod restarted without "
        f"quarantine in {nums['crashloop_fixed_s']:.2f} s")
    return nums


def run_slice_loop(tmp: str, chips: list) -> dict:
    """``tests/test_multihost_slice_loop.py`` with the card's node as one
    host: four kubelet rigs over gRPC (the card's over the real cards,
    three over ``SyntheticChipServicer`` boards) form ``RES_SLICE``, which
    goes ready; the card's cards go Unhealthy, the slice not ready with a
    ``SliceDegraded`` Event naming the card's node; back, ready again."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.discovery import tfd
    from tpu_operator_torch.kube import kubelet_sim, kubesim, testing
    from tpu_operator_torch.plugin import server as plugin
    from tpu_operator_torch.schedsim.engine import SyntheticChipServicer

    ns = consts.DEFAULT_NAMESPACE
    n = len(chips)
    env = {"TPU_SLICE_ID": RES_SLICE, "TPU_WORKER_ID": "0", "TPU_TOPOLOGY": "4x8"}
    labels = tfd.gather_features({"metadata": {"name": OPERANDS_NODE, "labels": {}}}, dev_root="/dev",
                                 driver_root="/", env=env, chips=chips)
    if (labels.get(consts.TFD_SLICE_HOSTS_LABEL), labels.get(consts.TFD_SLICE_ID_LABEL)) != ("4", RES_SLICE):
        raise RuntimeError(f"feature discovery did not put the card's node in a 4-host slice: {labels}")

    def member(i):
        return {consts.TFD_SLICE_ID_LABEL: RES_SLICE, consts.TFD_SLICE_HOSTS_LABEL: "4",
                consts.TFD_WORKER_ID_LABEL: str(i + 1), consts.TFD_TOPOLOGY_LABEL: "4x8"}

    nums = {}
    members = [OPERANDS_NODE, *RES_FLEET]
    with _card_fleet(os.path.join(tmp, "slice"), chips, labels, fleet_labels=member) as (server, raw, capacity, _):
        stops = []
        try:
            for name in RES_FLEET:
                socket_dir = os.path.join(tmp, "slice", f"k-{name}")
                kubelet = kubelet_sim.KubeletDeviceManager(kubesim.make_client(server.port), name, socket_dir)
                kubelet.start()
                stops.append(kubelet.stop)
                rig = plugin.DevicePluginServer(SyntheticChipServicer(chips=testing.HOST_CARDS, host=name),
                                                socket_dir=socket_dir)
                rig.start()
                stops.append(rig.stop)
                rig.register_with_kubelet(kubelet.kubelet_socket)
            _wait_for("every rig's cards advertised", lambda: [node_caps(raw, m)[1] for m in members] == [
                str(n)] + [str(testing.HOST_CARDS)] * len(RES_FLEET), RESILIENCE_WAIT_S)

            def verdicts(value):
                return all(_labels_of(raw, m).get(consts.SLICE_READY_LABEL) == value for m in members)

            with testing.running_operator(kubesim.make_client(server.port), ns, members):
                _wait_for("the slice ready", lambda: verdicts("true") and (_cr_status(raw).get("slices") or {}).get(
                    "ready") == 1, RESILIENCE_WAIT_S)
                t0 = time.perf_counter()
                capacity(0)
                _wait_for("the slice not ready, its Event naming the card's node", lambda: verdicts("false") and _event(
                    raw, "SliceDegraded", RES_SLICE, OPERANDS_NODE), RESILIENCE_WAIT_S)
                nums["slice_not_ready_s"] = time.perf_counter() - t0
                if node_caps(raw, RES_FLEET[0])[1] != str(testing.HOST_CARDS):
                    raise RuntimeError("a healthy host lost its cards with the card's")
                t0 = time.perf_counter()
                capacity(None)
                _wait_for("the slice ready again", lambda: verdicts("true") and (_cr_status(raw).get("slices") or {})
                          .get("ready") == 1, RESILIENCE_WAIT_S)
                nums["slice_ready_again_s"] = time.perf_counter() - t0
        finally:
            for stop in reversed(stops):
                stop()
    log(f"slice loop with the card's node: 4 rigs over gRPC ({n} + 3 x {testing.HOST_CARDS} cards) ready; every card "
        f"of the card's node unhealthy -> {RES_SLICE} not ready in {nums['slice_not_ready_s']:.2f} s with its "
        f"SliceDegraded Event naming {OPERANDS_NODE}; healthy -> ready in {nums['slice_ready_again_s']:.2f} s")
    return nums


def _slice_verdicts(raw) -> tuple:
    """(expected, actual) slice verdicts of every GPU node: the expected
    ones recomputed from live state (validator pods, allocatable,
    maintenance), as ``tests/test_chaos_kubesim.py``'s oracle does."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.controllers import slice_status

    live = [n for n in raw.list("v1", "Node") if consts.GPU_PRODUCT_LABEL in (n["metadata"].get("labels") or {})]
    validated = slice_status.validator_ready_nodes(raw, consts.DEFAULT_NAMESPACE)
    by_name = {n["metadata"]["name"]: n for n in live}
    expected = {}
    for info in slice_status.group_slices(live).values():
        ready = sum(1 for m in info.member_nodes if m in validated
                    and slice_status.host_allocatable_ok(by_name[m]) is not False
                    and not (by_name[m]["metadata"].get("labels") or {}).get(consts.MAINTENANCE_STATE_LABEL))
        want = info.expected_hosts or len(info.member_nodes)
        verdict = "true" if want > 0 and ready >= want and len(info.member_nodes) >= want else "false"
        expected.update({m: verdict for m in info.member_nodes})
    actual = {m: (by_name[m]["metadata"].get("labels") or {}).get(consts.SLICE_READY_LABEL) for m in by_name}
    return expected, actual


def run_chaos(tmp: str, chips: list, labels: dict) -> dict:
    """``tests/test_chaos_kubesim.py``'s storm, seeded with its
    ``CHAOS_SEED``, on a fleet holding the card's node: nodes join and
    leave, operand DaemonSets and pods vanish, the exporter toggles, the
    driver version bumps under a rolling upgrade, labels and slice verdicts
    are scribbled, watch lines dropped and the card's cards flip in its
    plugin, while the whole operator runs, crashes halfway and restarts.
    Then the fleet must settle READY with every upgrade done, every slice
    verdict equal to its recomputation and the worker still passing."""
    import itertools
    import random
    import threading

    from tpu_operator_torch import consts
    from tpu_operator_torch.kube import client as kclient
    from tpu_operator_torch.kube import kubesim, rest, testing
    from tpu_operator_torch.upgrade import upgrade_state

    ns = consts.DEFAULT_NAMESPACE
    api_errors = (kclient.ConflictError, kclient.NotFoundError, rest.TransientAPIError, OSError)
    nums = {}
    with _card_fleet(os.path.join(tmp, "chaos"), chips, labels) as (server, raw, capacity, servicer):
        rng = random.Random(CHAOS_SEED)
        nodes = [OPERANDS_NODE, *RES_FLEET]
        next_node = itertools.count(len(nodes))
        versions = (f"550.{i}.0" for i in itertools.count(100))
        drops = [2]
        card_ids = sorted((str(c["index"]) for c in chips), key=int)
        halt = threading.Event()

        def mutate_cp(fn):
            for _ in range(10):
                try:
                    cp = raw.get(consts.API_VERSION, consts.CLUSTER_POLICY_KIND, "cluster-policy", copy=True)
                    fn(cp)
                    raw.update(cp)
                    return
                except api_errors:
                    time.sleep(0.02)

        def add_node():
            if len(nodes) < CHAOS_MAX_NODES:
                name = f"chaos-node-{next(next_node)}"
                raw.create(testing.make_gpu_node(name))
                server.sim.set_node_chips(name, testing.HOST_CARDS)
                nodes.append(name)

        def del_node():
            candidates = [m for m in nodes if m != OPERANDS_NODE]
            if candidates:
                name = rng.choice(candidates)
                try:
                    raw.delete("v1", "Node", name)
                finally:
                    if raw.get_or_none("v1", "Node", name) is None and name in nodes:
                        nodes.remove(name)

        def del_random(av, kind):
            objs = raw.list(av, kind, ns)
            if objs:
                raw.delete(av, kind, rng.choice(objs)["metadata"]["name"], ns)

        def scribble(key, value):
            node = raw.get_or_none("v1", "Node", rng.choice(nodes), copy=True)
            if node is not None:
                node["metadata"].setdefault("labels", {})[key] = value
                raw.update(node)

        def drop_watch_line():
            if drops[0] > 0:
                drops[0] -= 1
                server.sim.inject_watch_drop(rng.choice(["pods", "nodes", "daemonsets", "configmaps"]))

        def flip_card():
            card = rng.choice(card_ids)
            (servicer.mark_unhealthy if rng.random() < 0.5 else servicer.mark_healthy)(card)

        actions = [
            add_node, del_node, lambda: del_random("apps/v1", "DaemonSet"), lambda: del_random("v1", "Pod"),
            lambda: mutate_cp(lambda cp: cp["spec"]["metricsExporter"].update(
                enabled=not cp["spec"]["metricsExporter"].get("enabled", True))),
            lambda: mutate_cp(lambda cp, v=next(versions): cp["spec"]["driver"].update(version=v)),
            lambda: scribble("chaos.test/touch", str(rng.randrange(1 << 30))),
            drop_watch_line,
            lambda: scribble(consts.SLICE_READY_LABEL, rng.choice(["true", "false", "banana"])),
            flip_card,
        ]

        done = {"actions": 0, "api_errors": 0}

        def storm():
            deadline = time.monotonic() + CHAOS_CHURN_S
            while not halt.is_set() and time.monotonic() < deadline:
                done["actions"] += 1
                try:
                    rng.choice(actions)()
                except api_errors:
                    done["api_errors"] += 1
                halt.wait(rng.uniform(0.02, 0.15))
            done["ended"] = time.perf_counter()

        churn = threading.Thread(target=storm, daemon=True)
        churn.start()
        try:
            with testing.running_operator(kubesim.make_client(server.port), ns, nodes):
                mutate_cp(lambda cp: cp["spec"]["driver"].update(upgradePolicy={
                    "autoUpgrade": True, "maxParallelUpgrades": 2, "maxUnavailable": "50%"}))
                time.sleep(CHAOS_CHURN_S / 2)
            with testing.running_operator(kubesim.make_client(server.port), ns, nodes) as mgr:
                time.sleep(CHAOS_CHURN_S / 2 + 1.0)
                churn.join(timeout=30)
                mutate_cp(lambda cp: cp["spec"]["metricsExporter"].update(enabled=True))
                capacity(None)

                def settled():
                    if _cr_status(raw).get("state") != "ready":
                        return False
                    for node in raw.list("v1", "Node"):
                        state = (node["metadata"].get("labels") or {}).get(consts.UPGRADE_STATE_LABEL)
                        if state not in (None, upgrade_state.STATE_DONE) or (node.get("spec") or {}).get(
                                "unschedulable"):
                            return False
                    expected, actual = _slice_verdicts(raw)
                    return expected == actual and expected.get(OPERANDS_NODE) == "true"

                _wait_for("the fleet settled after the storm", settled, max(180.0, 15.0 * len(nodes)))
                nums["chaos_converge_s"] = time.perf_counter() - done["ended"]
                mgr.enqueue("clusterpolicy")
                _wait_for("a pass after the storm", lambda: mgr.healthy() and mgr._last_reconcile_ok,
                          RESILIENCE_WAIT_S)
        finally:
            halt.set()
            churn.join(timeout=30)
    nums.update(chaos_nodes=len(nodes), chaos_actions=done["actions"])
    log(f"chaos churn with the card's node (seed {CHAOS_SEED}, {CHAOS_CHURN_S:.0f} s, {done['actions']} actions, "
        f"{done['api_errors']} refused, the operator restarted halfway): {len(nodes)} nodes settled READY "
        f"{nums['chaos_converge_s']:.2f} s after the storm ended, every upgrade done and every slice verdict equal "
        f"to its recomputation")
    return nums


def check_alert_names(n: int) -> dict:
    """Every metric an alert of the port's two PrometheusRule assets names
    is exported: ``OperatorMetrics`` on the global registry, ``NodeMetrics``
    (whose gauges ``run()`` creates) on a scratch registry on the card's
    node, its ``gpu_validator_gpu_devices`` equal to the card count."""
    import yaml
    from prometheus_client import REGISTRY, CollectorRegistry

    from tpu_operator_torch.controllers import state_manager
    from tpu_operator_torch.controllers.operator_metrics import OperatorMetrics
    from tpu_operator_torch.validator.metrics import NodeMetrics

    OperatorMetrics()
    scratch = CollectorRegistry()
    nm = NodeMetrics(node_name=OPERANDS_NODE, port=0, registry=scratch)
    try:
        nm.run(block=False)
        devices = _wait_for("gpu_validator_gpu_devices", lambda: scratch.get_sample_value(
            "gpu_validator_gpu_devices", {"node": OPERANDS_NODE}), RESILIENCE_WAIT_S)
        known = {m.name for m in REGISTRY.collect()} | {m.name for m in scratch.collect()}
    finally:
        nm.stop()
    alerts, unknown = 0, []
    for state, name in (("state-operator-metrics", "0300_prometheus_rule.yaml"),
                        ("state-node-status-exporter", "0800_prometheus_rule.yaml")):
        with open(os.path.join(state_manager.PACKAGE_ASSETS_DIR, state, name)) as f:
            doc = yaml.safe_load(f)
        for group in doc["spec"]["groups"]:
            for rule in group["rules"]:
                alerts += 1
                names = re.findall(r"\b(gpu_operator_\w+|gpu_validator_\w+)", rule["expr"])
                unknown += [(rule["alert"], m) for m in names or ["<none>"]
                            if m not in known and m.removesuffix("_total") not in known]
    if unknown or devices != n:
        raise RuntimeError(f"alerts naming no exported metric: {unknown}; gpu_validator_gpu_devices {devices}, "
                           f"{n} card(s)")
    log(f"alert rules: the {alerts} alerts' metrics all exported; NodeMetrics on the card's node reads "
        f"gpu_validator_gpu_devices {devices:.0f}")
    return {"alerts": alerts}


def phase_resilience() -> None:
    """The reference's fault, remediation, multi-host slice, chaos and
    alert-rule suites with the card's node in the fleet (phase 18):
    ``run_fault_matrix``, ``run_remediation_matrix``, ``run_slice_loop``,
    ``run_chaos`` and ``check_alert_names``."""
    from tpu_operator_torch import _build
    from tpu_operator_torch import consts
    from tpu_operator_torch.discovery import tfd
    from tpu_operator_torch.native import gpuinfo
    from tpu_operator_torch.obs import flight

    t_phase = time.perf_counter()
    _build.reset_launches()
    n = torch.cuda.device_count()
    chips = gpuinfo.chip_summary()
    if len(chips) != n:
        raise RuntimeError(f"the chip table {chips} holds not the {n} cards torch sees")
    saved = {key: os.environ.get(key) for key in (consts.OPERATOR_NAMESPACE_ENV, "INFORMER_RESYNC_INTERVAL_S")}
    os.environ[consts.OPERATOR_NAMESPACE_ENV] = consts.DEFAULT_NAMESPACE
    # resync fast enough that a dropped watch line heals inside the settle
    os.environ["INFORMER_RESYNC_INTERVAL_S"] = "5"
    flight_dir = flight.RECORDER.dir
    faulthandler.dump_traceback_later(RESILIENCE_TIMEOUT_S, exit=True)
    nums = {}
    with tempfile.TemporaryDirectory(prefix="cs18-") as tmp:
        flight.RECORDER.dir = os.path.join(tmp, "flight")
        try:
            labels = tfd.gather_features({"metadata": {"name": OPERANDS_NODE, "labels": {}}},
                                         dev_root="/dev", driver_root="/", env={}, chips=chips)
            check_features(labels, n)
            nums.update(run_fault_matrix(tmp, chips, labels))
            nums.update(run_remediation_matrix(tmp, chips, labels))
            nums.update(run_slice_loop(tmp, chips))
            nums.update(run_chaos(tmp, chips, labels))
            nums.update(check_alert_names(n))
        finally:
            flight.RECORDER.dir = flight_dir
            faulthandler.cancel_dump_traceback_later()
            for key, value in saved.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
    launched = {k: v for k, v in _build.launches.items() if v}
    if launched:
        raise RuntimeError(f"the resilience suites launched kernels of the package: {launched}")
    nums["phase_s"] = time.perf_counter() - t_phase
    log(f"resilience on: {_card_line()}; {json.dumps(nums)}; no kernel of the package launched; "
        f"phase 18 {nums['phase_s']:.1f} s")


def phase_cli(chain) -> None:
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as status_dir:
        for component, args, status_file in chain:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "tpu_operator_torch.validator",
                 "--component", component, *args, "--output-dir", status_dir],
                capture_output=True, text=True, timeout=400,
            )
            path = os.path.join(status_dir, status_file)
            if proc.returncode != 0 or not os.path.exists(path):
                raise RuntimeError(
                    f"CLI {component} failed rc={proc.returncode}:\n{proc.stderr[-3000:]}"
                )
            with open(path) as f:
                payload = json.load(f)
            if payload.get("ok") is not True:
                raise RuntimeError(f"CLI {component} wrote {status_file} without ok: {payload}")
            log(f"cli {component}: rc=0 {time.perf_counter() - t0:.1f} s "
                f"{status_file}={json.dumps(payload)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase_setup()
    kernels, partial = phase_kernels()
    launches = phase_main_path()
    attribution = phase_attribution()
    variant_kernels = {name for _, name, _ in VARIANTS}
    for k in kernels:
        k["launches"] = (attribution if k["name"] in variant_kernels else launches)[k["name"]]
    kernels += phase_structural(partial)
    phase_multidevice()
    phase_node_agents()
    phase_device_stack()
    phase_node_operands()
    phase_native()
    phase_control_plane()
    phase_control_plane_rw()
    phase_state_machine()
    phase_node_fsms()
    phase_reconcilers()
    phase_operator()
    phase_churn()
    phase_lint_e2e()
    phase_resilience()
    phase_cli(CLI_CHAIN + MULTIDEVICE_CLI)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
