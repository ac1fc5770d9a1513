"""Test helpers of the port (the twin of ``accelerate_tpu/test_utils/``):
``gang.run_gang`` launches a gloo world of CPU processes running a worker
function of ``test_utils/scripts``."""
