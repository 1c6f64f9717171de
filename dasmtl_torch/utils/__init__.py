"""Host utilities of the port (copies of ``dasmtl/utils/`` modules)."""
