"""``tests/test_data.py`` against the port's ``data/`` (loaded and renamed
by ``tests/_torch_suites.py``): the 22 of its 30 cases that
``test_torch_data.py`` does not already hold. The 8 it holds are dropped
here, so that no case runs twice; ``test_trainer_ingests_dataset`` is one
of them, ported there onto ``TorchTrainer``.

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(
    globals(),
    "data",
    drop=(
        "test_range_count_take",
        "test_iter_batches_sizes",
        "test_limit_and_split",
        "test_streaming_split_disjoint_and_complete",
        "test_trainer_ingests_dataset",
        "test_streaming_split_reiterable",
        "test_streaming_split_equal",
        "test_early_abandonment_stops_prefetch",
    ),
)
