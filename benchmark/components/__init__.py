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
"""
