"""`jx` command-line interface of the port."""
