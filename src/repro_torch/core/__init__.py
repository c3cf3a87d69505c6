"""Galaxy's core: hybrid model parallelism (hmp, ring), planning (planner,
profiler, costmodel) and the execution-plan layer (execplan)."""
