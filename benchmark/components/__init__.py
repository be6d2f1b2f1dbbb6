"""One module a component a mix may name.

Each module gives:

* ``prepare(run, w)``: checks that the configuration's widths ``w`` are
  the ones the program runs, and returns the shapes its kernels run at
  (``{"k3": {...}, "k2": {...}}``), which the rooflines read;
* ``call(run, w)``: one call into the program, returning its payload; a
  failed admission raises the validator's ``ValidationError``;
* ``verdict(payload, run, w)``, where a component has it: why a payload
  that raised nothing fails the node, or ``None``;
* ``numbers(payload, run, w)``: the payload's numbers that ``correct``
  holds to their limits (the largest over the window's passes counts);
* ``compare(run, w, gen, control)``: the timed path's kernels on inputs
  drawn from ``gen``, at the configuration's widths, against the plain
  reference; with ``control`` the reference one precision lower stands in
  for the program;
* ``BUILDERS``: the program's kernel builders the entry's call goes
  through, as ``(module path, attribute)``;
* ``held(run, w, builds, control)``: what the functions those builders
  made in one call of the entry ran and produced (``record.Build``), held
  to the configuration's widths and to the plain reference.

In a cell on more than one card (``chips`` n > 1) every one of these runs
in every rank's process (``benchmark/world.py``): rank 0 is the harness's
own, ranks 1 to n-1 are helpers. Each gets a ``Run`` of its own whose
``device`` is its card (``cuda:r``) and whose ``rank`` is the program's
``tpu_operator_torch.workloads.mesh.Rank``, set up as ``mesh.spawn_world``
sets up a rank, so that a component calls the program's rank functions
(``rank_ring_probe(run.rank, ...)``) as the world would. On a cell on one
card ``rank`` is ``None``. The ranks run each function at once, in the same
order, so that their collectives meet:

* a pass calls each component on every rank; it ends once rank 0 has
  synchronised its card and every helper has said that it synchronised
  its own;
* the pass fails the node where any rank's ``verdict`` fails it or any
  rank raises ``ValidationError``; any other error on any rank fails the
  run;
* every number ``correct`` holds (from ``numbers``, ``compare`` or
  ``held``) counts as its largest over the ranks that give it, as it
  counts as its largest over the passes; a rank may leave a number out;
* the shapes that the readers take are rank 0's; a helper's state and
  payloads stay in its process, and only its numbers, verdicts and trace
  come back.
"""
