"""Evaluation metrics of the port (BLEU)."""
