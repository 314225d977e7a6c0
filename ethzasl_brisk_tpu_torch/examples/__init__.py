"""The JAX package's examples on the port, each runnable with ``python -m``:
``cameras_demo`` (cameras and the camera-aware feature), ``live_pipeline``
(the batched step over a directory of PGM frames) and ``draw`` (the
headless match drawing it uses)."""
