"""``tests/test_slo_autopilot.py``, all 19 cases, against
the port's serve autoscaling and SLO autopilot (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "slo_autopilot")
