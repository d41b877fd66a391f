"""Train and serve entry points, device meshes and the sharding plan: the
port of ``repro.launch`` (``serve --model-axis`` shards the paged pool over
a mesh, ``train --model-axis`` trains over one).  The reference's XLA dry
run (``dryrun.py``, ``specs.py``) has no counterpart: ROADMAP, Modules
with no counterpart."""
