"""Result summaries. Counterpart of ``save_all_test_results`` in
``unet_zoo_tpu/utils/visualize.py``; the plots are not ported yet (ROADMAP
Queue 1 item 11)."""

from __future__ import annotations

from typing import Dict, Tuple


def save_all_test_results(all_test_results: Dict[str, Tuple[float, float]],
                          test_results_path: str, logger):
    """Text summary of test metrics with the winner by Dice."""
    text = "=" * 60 + "\nFINAL TEST SET EVALUATION RESULTS\n" + "=" * 60 + "\n\n"
    best, winner = -1.0, "N/A"
    for name, (loss, dc) in all_test_results.items():
        text += f"{name.replace('_', ' ').title()} Test Results:\n"
        text += f"  Test Loss: {loss:.6f}\n  Test DICE: {dc:.6f}\n\n"
        if dc > best:
            best, winner = dc, name.replace("_", " ").title()
    text += f"BEST TEST PERFORMANCE: {winner}\n"
    text += f"Best Test DICE: {best:.6f}\n" + "=" * 60 + "\n"
    with open(test_results_path, "w") as f:
        f.write(text)
    logger.log_both(text)
