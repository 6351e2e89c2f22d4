"""Adaptive mesh refinement (the reference's AMR variant, amr/): the
hanging-node forest, the state transfers, the AMR operator and its time
loop.  The port of `laghos_tpu.amr`."""
