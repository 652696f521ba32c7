from densepoints.utils.logging import StageMetrics, log
