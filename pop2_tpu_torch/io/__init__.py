"""Input and output of the port: exact-restart checkpoints
(``restart.py``) and the netCDF-4 writer of the output streams
(``netcdf4.py``)."""
