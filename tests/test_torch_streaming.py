"""Twin of tests/test_streaming.py on the port: the trace cursor, the
watcher's streamed aggregates equal to the post-hoc ones on both engines
and under retries, the health rules firing once, the watch CLI, and the
Chrome trace's service slices and alert instants."""
from torch_twin import twin_of

globals().update(twin_of("test_streaming.py"))
