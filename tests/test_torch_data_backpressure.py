"""``tests/test_data_backpressure.py``, both cases (1 of them `slow`, as in the reference), against
the port's ``data/`` on its own small-store cluster (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "data_backpressure")
