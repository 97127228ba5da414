"""Input and output of the port: exact-restart checkpoints
(``restart.py``) and their sharded form, a block a rank
(``sharded_restart.py``), the netCDF-4 writer of the output streams
(``netcdf4.py``), the POP-format grid, topography and vertical-grid files
(``grid_files.py``), general POP-binary field files (``pop_binary.py``),
the reference's per-grid text inputs (``input_templates.py``) and the
post-run processing of the stream files (``postrun.py``)."""
