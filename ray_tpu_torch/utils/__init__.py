"""Port of the matching ray_tpu subpackage."""
