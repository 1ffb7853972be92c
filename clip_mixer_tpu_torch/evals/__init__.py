"""Evaluations: the zero-shot classifier and the int8 noise-floor gates."""
