"""Host-side utilities of the port: training statistics, metric logs, a
TensorBoard writer and the profiler hook."""
