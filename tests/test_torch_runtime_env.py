"""``tests/test_runtime_env.py``, all 5 cases, against
the port's runtime environments (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "runtime_env")
