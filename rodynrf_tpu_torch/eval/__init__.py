"""Evaluation: metrics, test-set evaluation, novel-view paths."""
