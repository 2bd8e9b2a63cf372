"""Traffic loops, one module a loop, found by the name a traffic mix's
``loop`` gives.  Each has a class ``Loop(op, traffic, pool, seed)`` with
``warm()`` (every shape the window uses, before it), ``calls()`` (the calls
returned so far) and ``measure(seconds, at=None) -> (calls, lost)``."""
