"""APM submodules of the port."""
