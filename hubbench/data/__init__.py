"""Seeded data generators, one module a generator, found by the name a
configuration's ``data.generator`` gives.  Each has ``generate(spec, rows,
queries, dims, gen, device) -> (rows [N, D] f32, queries [Q, D] f32)``,
drawn from the ``torch.Generator`` ``gen`` on ``device`` in a fixed order,
so that one seed gives the same inputs on every run."""
