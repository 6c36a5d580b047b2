"""Utilities of the port: experiment logging and TensorBoard scalars
(`logging_utils`, `tb_events`), step timers and traces (`profiling`),
and the benchmark lock (`bench_lock`)."""
