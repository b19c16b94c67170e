"""Step functions and entry points of the port (counterpart of ``repro.launch``)."""
