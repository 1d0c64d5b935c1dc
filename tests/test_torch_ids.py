"""``tests/test_ids.py``, all 4 cases, against
the port's ids (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "ids")
