"""Domain decomposition over ranks: ``mesh`` (the blocks, the halo
exchanges, the kernels' extended launches) and ``multihost`` (the process
group, gathers and scatters, ``spawn_ranks``)."""
