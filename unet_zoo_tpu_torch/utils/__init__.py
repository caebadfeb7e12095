"""Weight conversion, serving, checkpoints, logging and result summaries of the port."""
