"""Dice-plateau learning-rate scheduler. Counterpart of
``unet_zoo_tpu/train/lr_scheduler.py``: the same state machine (a counter
of epochs without improvement, the rate cut by ``factor`` down to
``min_lr``, the counter reset after each cut), the same prints and
``state_dict``. The loop sets the optimizer's rate when it moves
(``train.steps.set_lr``).
"""

from __future__ import annotations

from typing import Optional


class DiceScheduler:
    def __init__(self, lr: float, patience: int = 8, factor: float = 0.5,
                 min_lr: float = 1e-7, min_delta: float = 0.001,
                 verbose: bool = True, mode: str = "max"):
        self.lr = float(lr)
        self.patience = int(patience)
        self.factor = float(factor)
        self.min_lr = float(min_lr)
        self.min_delta = float(min_delta)
        self.verbose = verbose
        self.mode = mode.lower()
        if self.mode not in ("min", "max"):
            raise ValueError(f"Mode must be 'min' or 'max', got '{mode}'")
        self.best_score: Optional[float] = None
        self.counter = 0
        self.num_bad_epochs = 0
        self.last_lr_reduction = 0

    def step(self, val_score: float, epoch: Optional[int] = None) -> float:
        """Update with this epoch's score; returns the (possibly reduced) lr."""
        if self.best_score is None:
            self.best_score = val_score
            if self.verbose:
                print(f"DiceScheduler: Initial best score set to {self.best_score:.6f}")
        elif not self._is_improvement(val_score):
            self.counter += 1
            self.num_bad_epochs += 1
            if self.verbose and self.counter % 2 == 0:
                print(
                    f"DiceScheduler: No improvement for {self.counter} epochs "
                    f"(current: {val_score:.6f}, best: {self.best_score:.6f})"
                )
            if self.counter >= self.patience:
                old_lr = self.lr
                self.lr = max(self.lr * self.factor, self.min_lr)
                if self.lr < old_lr:
                    self.last_lr_reduction = (
                        epoch if epoch is not None else self.last_lr_reduction + 1
                    )
                    if self.verbose:
                        print(
                            f"Reducing learning rate from {old_lr:.6f} to {self.lr:.6f}"
                        )
                elif self.verbose and old_lr <= self.min_lr:
                    print(
                        f"Learning rate {old_lr:.6f} already at minimum "
                        f"({self.min_lr:.6f})"
                    )
                self.counter = 0
        else:
            improvement = (
                val_score - self.best_score
                if self.mode == "max"
                else self.best_score - val_score
            )
            if self.verbose and improvement > self.min_delta:
                print(
                    f"DiceScheduler: New best score {val_score:.6f} "
                    f"(improvement: {improvement:+.6f})"
                )
            self.best_score = val_score
            self.counter = 0
            self.num_bad_epochs = 0
        return self.lr

    def _is_improvement(self, score: float) -> bool:
        if self.mode == "max":
            return score > self.best_score + self.min_delta
        return score < self.best_score - self.min_delta

    def get_last_lr(self):
        return [self.lr]

    def state_dict(self) -> dict:
        return {
            "lr": self.lr,
            "best_score": self.best_score,
            "counter": self.counter,
            "num_bad_epochs": self.num_bad_epochs,
            "last_lr_reduction": self.last_lr_reduction,
            "mode": self.mode,
        }

    def load_state_dict(self, state: dict) -> None:
        self.lr = state.get("lr", self.lr)
        self.best_score = state.get("best_score")
        self.counter = state.get("counter", 0)
        self.num_bad_epochs = state.get("num_bad_epochs", 0)
        self.last_lr_reduction = state.get("last_lr_reduction", 0)
