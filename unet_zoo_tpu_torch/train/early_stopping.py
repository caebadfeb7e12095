"""Early stopping on validation Dice. Counterpart of
``unet_zoo_tpu/train/early_stopping.py``: the same state machine (patience
counter, mode min/max), prints and ``state_dict``. The JAX package keeps a
reference to its immutable weights; a torch ``state_dict`` aliases the live
parameters, so the best weights are cloned when saved.
"""

from __future__ import annotations

from typing import Any, Optional


class EarlyStopping:
    def __init__(self, patience: int = 20, min_delta: float = 0.001,
                 restore_best_weights: bool = True, verbose: bool = True,
                 mode: str = "max"):
        self.patience = patience
        self.min_delta = min_delta
        self.restore_best_weights = restore_best_weights
        self.verbose = verbose
        self.mode = mode.lower()
        if self.mode not in ("min", "max"):
            raise ValueError(f"Mode must be 'min' or 'max', got '{mode}'")
        self.best_score: Optional[float] = None
        self.counter = 0
        self.best_weights: Any = None
        self.stopped_epoch = 0
        self.early_stop = False

    def __call__(self, val_score: float, weights: Any, epoch: int) -> bool:
        """Update with this epoch's score. ``weights`` is a ``state_dict``
        (or any mapping of tensors). Returns True when stopping triggers."""
        if self.best_score is None:
            self.best_score = val_score
            self._save(weights)
            if self.verbose:
                print(f"EarlyStopping: Initial best score set to {self.best_score:.6f}")
        elif self._is_improvement(val_score):
            if self.verbose:
                print(
                    f"EarlyStopping: New best score {val_score:.6f} "
                    f"(improvement: {self._improvement(val_score):+.6f})"
                )
            self.best_score = val_score
            self._save(weights)
            self.counter = 0
        else:
            self.counter += 1
            if self.verbose:
                print(
                    f"EarlyStopping counter: {self.counter} out of {self.patience} "
                    f"(current: {val_score:.6f}, best: {self.best_score:.6f})"
                )
            if self.counter >= self.patience:
                self.stopped_epoch = epoch
                self.early_stop = True
                return True
        return False

    def _is_improvement(self, score: float) -> bool:
        if self.mode == "max":
            return score > self.best_score + self.min_delta
        return score < self.best_score - self.min_delta

    def _improvement(self, score: float) -> float:
        return score - self.best_score if self.mode == "max" else self.best_score - score

    def _save(self, weights: Any) -> None:
        if self.restore_best_weights:
            # a state_dict's tensors are the live parameters: clone them
            self.best_weights = {k: v.detach().clone() for k, v in weights.items()}

    def get_best_score(self) -> Optional[float]:
        return self.best_score

    def state_dict(self) -> dict:
        return {
            "best_score": self.best_score,
            "counter": self.counter,
            "stopped_epoch": self.stopped_epoch,
            "early_stop": self.early_stop,
            "mode": self.mode,
        }

    def load_state_dict(self, state: dict) -> None:
        self.best_score = state.get("best_score")
        self.counter = state.get("counter", 0)
        self.stopped_epoch = state.get("stopped_epoch", 0)
        self.early_stop = state.get("early_stop", False)

    def reset(self) -> None:
        self.best_score = None
        self.counter = 0
        self.best_weights = None
        self.stopped_epoch = 0
        self.early_stop = False
