"""Evaluation metrics of the port (``ttsx/eval``); only the EER so far."""
