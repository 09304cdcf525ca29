"""Early stopping: the port of `deeplearning4j_tpu/earlystopping/`:
`EarlyStoppingConfiguration`, the trainer (`EarlyStoppingTrainer`, which
`EarlyStoppingGraphTrainer` names too: both model types expose fit / score /
clone), the validation score calculator, the epoch and iteration
termination conditions, and the model savers (in memory, or zips in a
directory through `ModelSerializer`), and `EarlyStoppingParallelTrainer`
over the data-parallel `parallel.ParallelTrainer`.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import List

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


# --------------------------- score calculators -----------------------------

class DataSetLossCalculator:
    """Average loss over a validation iterator (reference
    `scorecalc/DataSetLossCalculator.java`; the CG variant is the same class
    here — both model types expose `score(DataSet)`)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model) -> float:
        total, count = 0.0, 0
        self.iterator.reset()
        while self.iterator.has_next():
            ds = self.iterator.next()
            n = ds.num_examples()
            total += model.score(ds) * n
            count += n
        if count == 0:
            # an exhausted/empty validation iterator would silently score
            # 0.0 (or NaN from 0/0) — and a bogus 0.0 "best score" makes
            # early stopping save garbage as the best model. Fail loudly.
            raise ValueError(
                "DataSetLossCalculator: validation iterator yielded no "
                "examples — the score would be meaningless (0/0). Check "
                "that the iterator reset() works, is not already "
                "exhausted, and that drop_last/batch_size leave at least "
                "one batch")
        return total / count if self.average else total


# --------------------------- termination conditions ------------------------

class MaxEpochsTerminationCondition:
    def __init__(self, max_epochs: int):
        self.max_epochs = int(max_epochs)

    def terminate(self, epoch: int, score: float) -> bool:
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition:
    """Stop after N epochs with no (sufficient) improvement."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = int(max_epochs_without_improvement)
        self.min_improvement = float(min_improvement)
        self._best = math.inf
        self._since = 0

    def terminate(self, epoch: int, score: float) -> bool:
        if self._best - score > self.min_improvement:
            self._best = score
            self._since = 0
            return False
        self._since += 1
        return self._since > self.patience


class BestScoreEpochTerminationCondition:
    """Stop once the score is at least as good as a target."""

    def __init__(self, best_expected_score: float):
        self.best = float(best_expected_score)

    def terminate(self, epoch: int, score: float) -> bool:
        return score <= self.best


class MaxScoreIterationTerminationCondition:
    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def terminate(self, iteration: int, score: float) -> bool:
        return score > self.max_score


class InvalidScoreIterationTerminationCondition:
    def terminate(self, iteration: int, score: float) -> bool:
        return math.isnan(score) or math.isinf(score)


class MaxTimeIterationTerminationCondition:
    def __init__(self, max_seconds: float):
        self.max_seconds = float(max_seconds)
        self._start = None

    def terminate(self, iteration: int, score: float) -> bool:
        if self._start is None:
            self._start = time.monotonic()
            return False
        return time.monotonic() - self._start > self.max_seconds


# --------------------------- model savers ----------------------------------

class InMemoryModelSaver:
    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, model, score):
        self._best = model.clone()

    def save_latest_model(self, model, score):
        self._latest = model.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver:
    """Best and latest models as `bestModel.zip` / `latestModel.zip` in
    `directory`, restored onto the device of the model they were saved
    from."""

    def __init__(self, directory: str):
        self.directory = directory
        self._saved_on = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, name):
        return os.path.join(self.directory, name)

    def _write(self, model, name):
        from ..util.serializer import ModelSerializer
        ModelSerializer.write_model(model, self._path(name))
        self._saved_on = getattr(model, "device", None)

    def _read(self, name):
        from ..util.serializer import ModelSerializer
        return ModelSerializer.restore(self._path(name),
                                       device=self._saved_on)

    def save_best_model(self, model, score):
        self._write(model, "bestModel.zip")

    def save_latest_model(self, model, score):
        self._write(model, "latestModel.zip")

    def get_best_model(self):
        return self._read("bestModel.zip")

    def get_latest_model(self):
        return self._read("latestModel.zip")


# --------------------------- configuration + result ------------------------

@dataclass
class EarlyStoppingConfiguration:
    score_calculator: object = None
    model_saver: object = field(default_factory=InMemoryModelSaver)
    epoch_termination_conditions: List = field(default_factory=list)
    iteration_termination_conditions: List = field(default_factory=list)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False

    class Builder:
        def __init__(self):
            self._c = EarlyStoppingConfiguration()

        def score_calculator(self, sc):
            self._c.score_calculator = sc; return self

        def model_saver(self, ms):
            self._c.model_saver = ms; return self

        def epoch_termination_conditions(self, *conds):
            self._c.epoch_termination_conditions = list(conds); return self

        def iteration_termination_conditions(self, *conds):
            self._c.iteration_termination_conditions = list(conds); return self

        def evaluate_every_n_epochs(self, n):
            self._c.evaluate_every_n_epochs = int(n); return self

        def save_last_model(self, b=True):
            self._c.save_last_model = bool(b); return self

        def build(self):
            return self._c


@dataclass
class EarlyStoppingResult:
    termination_reason: str = ""
    termination_details: str = ""
    score_vs_epoch: dict = field(default_factory=dict)
    best_model_epoch: int = -1
    best_model_score: float = math.inf
    total_epochs: int = 0
    best_model: object = None


# --------------------------- trainer ---------------------------------------

class EarlyStoppingTrainer:
    """Epoch loop with score evaluation + termination checks (reference
    `trainer/BaseEarlyStoppingTrainer.java:46`)."""

    def __init__(self, config: EarlyStoppingConfiguration, model, train_iter):
        self.config = config
        self.model = model
        self.train_iter = train_iter

    def _model_for_saving(self):
        """The object handed to the model saver (overridden by the parallel
        trainer, whose `self.model` is a ParallelTrainer)."""
        return self.model

    def _fit_one(self, ds):
        """Train on one minibatch (overridden by the parallel trainer to
        skip the per-call param publish)."""
        self.model.fit(ds)

    def _epoch_score(self) -> float:
        """The epoch's score: the calculator's, else the last step's."""
        cfg = self.config
        return (cfg.score_calculator.calculate_score(self.model)
                if cfg.score_calculator else self.model.score())

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        result = EarlyStoppingResult()
        epoch = 0
        terminate = False
        reason, details = "", ""
        while not terminate:
            # one epoch, with iteration-level termination checks
            self.train_iter.reset()
            while self.train_iter.has_next():
                self._fit_one(self.train_iter.next())
                score = self.model.score()
                for cond in cfg.iteration_termination_conditions:
                    if cond.terminate(self.model.iteration_count, score):
                        reason = "IterationTerminationCondition"
                        details = type(cond).__name__
                        terminate = True
                        break
                if terminate:
                    break
            if terminate:
                break
            if (epoch % cfg.evaluate_every_n_epochs) == 0:
                score = self._epoch_score()
                result.score_vs_epoch[epoch] = score
                if score < result.best_model_score:
                    result.best_model_score = score
                    result.best_model_epoch = epoch
                    cfg.model_saver.save_best_model(
                        self._model_for_saving(), score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(
                        self._model_for_saving(), score)
                for cond in cfg.epoch_termination_conditions:
                    if cond.terminate(epoch, score):
                        reason = "EpochTerminationCondition"
                        details = type(cond).__name__
                        terminate = True
                        break
            epoch += 1
        result.total_epochs = epoch
        result.termination_reason = reason or "Unknown"
        result.termination_details = details
        result.best_model = cfg.model_saver.get_best_model()
        return result


# Graph models share the same trainer logic (both expose fit/score/clone)
EarlyStoppingGraphTrainer = EarlyStoppingTrainer


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    """Early stopping driving a data-parallel ParallelTrainer — reference
    `EarlyStoppingParallelTrainer.java` (there: a ParallelWrapper feeding
    the early-stopping loop; here the ParallelTrainer IS the model-like:
    `fit` runs its step over the ranks, `score` computes validation scores
    over them, and every termination condition and the best-model save
    path work unchanged).

    Pass a ParallelTrainer via `trainer`, or a model plus ParallelTrainer
    kwargs (mesh / mode / strategy / ...) to build one. A
    `DataSetLossCalculator` is scored through the trainer's lockstep
    scoring of its whole iterator, so ranks with unequal validation
    shards still agree on every epoch's score."""

    def __init__(self, config: EarlyStoppingConfiguration, model=None,
                 train_iter=None, trainer=None, **trainer_kwargs):
        if trainer is None:
            if model is None:
                raise ValueError("need a model or a ParallelTrainer")
            from ..parallel.trainer import ParallelTrainer
            trainer = ParallelTrainer(model, **trainer_kwargs)
        super().__init__(config, trainer, train_iter)
        self.trainer = trainer

    def _fit_one(self, ds):
        # the trainer's step directly: fit() would publish after every
        # minibatch, and in AVERAGING mode its sync-back averages the
        # replicas, collapsing the local-SGD window
        self.trainer._fit_batch(ds)

    def _epoch_score(self) -> float:
        calc = self.config.score_calculator
        if isinstance(calc, DataSetLossCalculator):
            total = count = 0.0
            for s, n in self.trainer._batch_scores(calc.iterator):
                total += s * n
                count += n
            if count == 0:
                raise ValueError(
                    "DataSetLossCalculator: validation iterator yielded no "
                    "examples — the score would be meaningless (0/0)")
            return total / count if calc.average else total
        return super()._epoch_score()

    def _model_for_saving(self):
        # non-destructive publish: AVERAGING binds the averaged view
        # without collapsing the live replicas
        return self.trainer.publish_view()
