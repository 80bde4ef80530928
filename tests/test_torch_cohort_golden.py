"""Twin of tests/test_cohort_golden.py on the port: a planned cohort wave
equal to the object path (metrics, series, trace counts, end time) on the
flux and hybrid configurations, the wave API, eligibility fallbacks and the
bulk profiler append."""
from torch_twin import twin_of

globals().update(twin_of("test_cohort_golden.py"))
