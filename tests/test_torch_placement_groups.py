"""``tests/test_placement_groups.py``, all 8 cases (1 of them `slow`, as in the reference), against
the port's placement groups (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "placement_groups")
