"""Twin of tests/test_observability.py on the port
(``repro_torch.observability``): the lifecycle breakdown telescoping on
both engines and the cohort path, the timeseries, the Chrome trace, the
``RunReport`` and the report CLI. The same artifacts equal the JAX
package's, exactly, in tests/test_torch_metrics_parity.py."""
from torch_twin import twin_of

globals().update(twin_of("test_observability.py"))
