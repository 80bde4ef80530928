"""Twin of tests/test_campaign.py on the port (``repro_torch.core``'s
``Campaign``, ``Stage`` and IMPECCABLE): DAG ordering, a diamond run once,
the IMPECCABLE task counts scaling with nodes. The reference's two
paper-scale tests (``slow`` there) are held in
tests/test_torch_metrics_parity.py, at 1,024 nodes, against the JAX
package's own numbers."""
from torch_twin import twin_of

globals().update(twin_of("test_campaign.py"))
