"""Grid sharding of the solve over ``torch.distributed`` ranks.

Counterpart of ``chsimpy_tpu/parallel/`` for the grid layout: the field is
tiled over an ``mx x my`` mesh of ranks (one rank per JAX mesh device),
each rank holding one ``(N/mx, N/my)`` block.

* :mod:`.mesh` — :class:`GridMesh`, the rank's coordinates and its row and
  column groups;
* :mod:`.distributed` — joining a process group (torchrun's ``env://``),
  binding each rank's card, :func:`spawn_grid` for in-process worlds;
* :mod:`.sharding` — blocks of the field, the constants and the state;
* :mod:`.collectives` — the halo exchange, the strip all-gathers of the
  grid DCTs and the rank-ordered sums;
* :mod:`.workers` — the functions a spawned world runs.
"""
