"""Train and serve entry points: the port of ``repro.launch`` (single
device; the mesh, sharding and dry-run modules wait for ROADMAP Queue 1
item 10)."""
