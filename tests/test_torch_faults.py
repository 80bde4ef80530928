"""Twin of tests/test_faults.py on the port: ``ChaosController`` node and
pilot kills on both engines (DAG with a gang, requeue to survivors, the
last pilot spared), seeded fault plans, ``fault_metrics`` from the trace,
and the fault model under them (double-free guard, retry backoff and
jitter, walltime with checkpoint banking). The reference's
``test_real_checkpoint_resume_contract`` saves numpy leaves through the JAX
package's manager; the port's twin, with tensors, is in
tests/test_torch_runtime.py."""
from torch_twin import twin_of

globals().update(twin_of("test_faults.py",
                         skip=("test_real_checkpoint_resume_contract",)))
