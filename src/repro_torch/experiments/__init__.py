"""Experiments of the port (counterparts of the reference's
``experiments/``): the dry-run hillclimbs (``hillclimb``) and the
calibration of the planner's cost model against measured HMP layers
(``calibrate``)."""
