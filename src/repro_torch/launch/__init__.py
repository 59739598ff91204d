"""Launch-side models of the port (twin of ``repro.launch``)."""
