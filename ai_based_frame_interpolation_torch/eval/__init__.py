"""Evaluation harness and text reports of the port."""
