from .earlystopping import (
    EarlyStoppingConfiguration, EarlyStoppingResult, EarlyStoppingTrainer,
    EarlyStoppingGraphTrainer, EarlyStoppingParallelTrainer,
    DataSetLossCalculator, InMemoryModelSaver,
    LocalFileModelSaver, MaxEpochsTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
    BestScoreEpochTerminationCondition, MaxScoreIterationTerminationCondition,
    InvalidScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
)

__all__ = [
    "EarlyStoppingConfiguration", "EarlyStoppingResult",
    "EarlyStoppingTrainer", "EarlyStoppingGraphTrainer",
    "EarlyStoppingParallelTrainer",
    "DataSetLossCalculator", "InMemoryModelSaver", "LocalFileModelSaver",
    "MaxEpochsTerminationCondition",
    "ScoreImprovementEpochTerminationCondition",
    "BestScoreEpochTerminationCondition",
    "MaxScoreIterationTerminationCondition",
    "InvalidScoreIterationTerminationCondition",
    "MaxTimeIterationTerminationCondition",
]
