"""Port of ``ray_tpu.air``: the run and scaling configs of the train
harness."""
