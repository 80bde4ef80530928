"""Twin of tests/test_service_faults.py on the port: a replica killed
mid-stream on both engines loses no request, restart lineage and budget,
autoscaling up and down within its bounds, and the stop protocol's
repairs."""
from torch_twin import twin_of

globals().update(twin_of("test_service_faults.py"))
