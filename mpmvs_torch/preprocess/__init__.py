"""COLMAP model -> MVS workspace conversion (``convert``), with the COLMAP
readers (``colmap``)."""
