"""Device meshes and data parallelism: the port of unicore_tpu/parallel."""
