"""Evaluation metrics and the report for generated populations (numpy)."""
