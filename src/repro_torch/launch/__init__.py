"""Train and serve entry points and device meshes: the port of
``repro.launch`` (``serve --model-axis`` shards the paged pool over a
mesh; the FSDP specs, sharded training and the dry run wait for ROADMAP
Queue 1 item 10's training part)."""
