"""Ops, one module an operation of the store, found by the name a traffic
mix's ``op`` gives.  Each has

- ``Op(version, traffic, config)``: ``op(items) -> (answer, s0, s1)``, one
  call with the span of the index's work inside it, and ``op.index``;
- ``score(answered, rows, pool, config, traffic) -> (numbers, recall)``:
  the numbers that decide ``correct`` (each with a limit in the
  configuration's ``limits``) over the answered calls, against the plain
  reference on the regenerated rows and pool, and the mean recall, or
  ``None`` where the op answers no search."""
