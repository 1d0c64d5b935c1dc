"""``tests/test_object_transfer.py``, all 17 cases, against
the port's object transfer and pull manager (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "object_transfer")
