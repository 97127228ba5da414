"""Domain decomposition over ranks: ``mesh`` (the y slabs, the halo
exchanges, the kernels' extended launches) and ``multihost`` (the process
group, gathers and scatters, ``spawn_ranks``)."""
