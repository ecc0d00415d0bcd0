"""Wire accounting of the port (counterpart of ``repro.comm``)."""
