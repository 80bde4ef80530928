"""Twin of tests/test_batch_golden.py on the port: a ``DescriptionBatch``
equal to the same descriptions submitted one by one (passthrough, cohort
and object fallback, gated release order under three policies, deps), on
both engines."""
from torch_twin import twin_of

globals().update(twin_of("test_batch_golden.py"))
