"""The harness's shared parts: finding files by name, the seeded signal,
the profiler's trace, and the result line."""
