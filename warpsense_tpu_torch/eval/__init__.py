"""Evaluation entry points: the reference's test nodes (test/pcd2tsdf.cpp,
test/pcd_registration.cpp) and the pipeline-level ATE and scans/s
evaluation, as in ``warpsense_tpu/eval``.  Each CLI runs on the card
unless ``--device cpu`` is given."""
