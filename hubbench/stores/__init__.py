"""Stores, one module a durability, found by the name a configuration's
``durability`` gives.  Each has ``open_store(config, traffic, device) ->
(hub, version)``: a store that gives the configuration's guarantees, and
the version of its one space that the traffic drives.  ``run.py`` refuses
a configuration whose durability has no module here."""
