from deeplearning4j_tpu_torch.ui.stats import (StatsListener, StatsReport,
                                               InMemoryStatsStorage,
                                               FileStatsStorage)
from deeplearning4j_tpu_torch.ui.server import UIServer

__all__ = ["StatsListener", "StatsReport", "InMemoryStatsStorage",
           "FileStatsStorage", "UIServer"]
