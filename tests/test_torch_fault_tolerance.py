"""``tests/test_fault_tolerance.py``, all 3 cases, against the port: node
death and actor restart on a new node, drain-vs-crash restart accounting,
and pool-actor recovery in Data (loaded and renamed by
``tests/_torch_suites.py``).

Statements that differ from the reference, and why:

* ``wait_for_node_resource`` comes from ``tests/_torch_suites.py``, not
  from conftest: conftest's polls the reference's ``nodes()``, the
  port's polls the port's cluster.
"""

from _torch_suites import load

EDITS = (
    (
        "from conftest import wait_for_node_resource",
        "from _torch_suites import wait_for_node_resource",
        "conftest's helper polls the reference's cluster",
    ),
)

load(globals(), "fault_tolerance", edits=EDITS)
