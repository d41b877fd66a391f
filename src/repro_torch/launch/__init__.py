"""Train and serve entry points, device meshes, the sharding plan and the
dry run: the port of ``repro.launch`` (``serve --model-axis`` shards the
paged pool over a mesh, ``train --model-axis`` trains over one;
``dryrun`` traces any (arch × shape × mesh) cell on fake devices under
``FakeTensorMode``, ``specs`` builds its cells and ``accounting`` counts
per device)."""
