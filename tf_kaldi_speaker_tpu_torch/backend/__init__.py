"""Scoring back end of the port (numpy): the validation metrics."""
