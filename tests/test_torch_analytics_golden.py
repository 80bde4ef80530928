"""Twin of tests/test_analytics_golden.py on the port: the vectorized
``compute_metrics`` and ``concurrency_series`` against the seed's
pure-Python ``_reference_*`` oracles on randomized traces, and the columnar
profiler. The reference's 100k-task smoke test (``slow`` there) is left to
it."""
from torch_twin import twin_of

globals().update(twin_of("test_analytics_golden.py"))
