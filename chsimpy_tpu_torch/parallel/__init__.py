"""Sharding of the solve and of the ensemble over ``torch.distributed``
ranks.

Counterpart of ``chsimpy_tpu/parallel/`` for the grid and pencil layouts
and the ensemble mesh: the field is tiled over an ``mx x my`` mesh of
ranks (one rank per JAX mesh device), each rank holding one ``(N/mx,
N/my)`` block, or, on the split and ozaki routes where the rank count
divides N, whole columns of the field and whole rows of its spectral
image (the pencil layout); an
ensemble's members are split over an 'ens' axis of ``E`` such grids.

* :mod:`.mesh` — :class:`GridMesh` and :class:`EnsembleMesh`, the rank's
  coordinates and its row, column, grid and ens groups, and a grid's
  pencil views;
* :mod:`.distributed` — joining a process group (torchrun's ``env://``
  or a coordinator's ``tcp://``), binding each rank's card,
  :func:`spawn_world` and :func:`spawn_grid` for in-process worlds;
* :mod:`.sharding` — blocks of the field, the constants and the state,
  and each rank's members;
* :mod:`.collectives` — the halo exchange, the strip all-gathers of the
  grid DCTs, the pencil transposes, the rank-ordered sums, the world max
  and the gather over the ens axis, each counting its calls and bytes;
* :mod:`.audit` — the bytes a step (or an ensemble's chunk) moves, by
  collective;
* :mod:`.dryrun` — the dry run of the mesh axes on a world of ranks
  against one device's runs;
* :mod:`.workers` — the functions a spawned world runs.
"""
