"""ray_tpu_torch.tune — experiment execution: trials, search, schedulers.

Reference: ``python/ray/tune/`` (Tuner/TuneController, basic-variant
search, ASHA). See ``tuner.py`` for the controller design."""

from ray_tpu_torch.tune.loggers import (
    CSVLoggerCallback,
    JSONLoggerCallback,
    LoggerCallback,
    TensorBoardLoggerCallback,
)
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.search import (
    ConcurrencyLimiter,
    OptunaSearch,
    RandomSearch,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    qrandint,
    randint,
    uniform,
)
from ray_tpu_torch.tune.trial import Trial, get_checkpoint, get_config, report
from ray_tpu_torch.tune.tuner import ResultGrid, TrialResult, TuneConfig, Tuner

__all__ = [
    "ASHAScheduler",
    "CSVLoggerCallback",
    "ConcurrencyLimiter",
    "FIFOScheduler",
    "JSONLoggerCallback",
    "LoggerCallback",
    "MedianStoppingRule",
    "OptunaSearch",
    "PopulationBasedTraining",
    "RandomSearch",
    "Searcher",
    "TPESearcher",
    "TensorBoardLoggerCallback",
    "get_checkpoint",
    "ResultGrid",
    "Trial",
    "TrialResult",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_config",
    "grid_search",
    "loguniform",
    "qrandint",
    "randint",
    "report",
    "uniform",
]
