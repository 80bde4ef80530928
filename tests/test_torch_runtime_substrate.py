"""Twin of tests/test_runtime_substrate.py on the port: one ``Campaign``
on both engines, identical across them, and the executor registry. The
reference's three tests that tests/test_torch_runtime.py already twins
by name are left out here."""
from torch_twin import twin_of

globals().update(twin_of("test_runtime_substrate.py", skip=(
    "test_subprocess_executor_runs_executables",
    "test_real_engine_retries_through_agent_pipeline",
    "test_session_pilot_state_machine")))
