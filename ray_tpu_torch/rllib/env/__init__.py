"""Env runners and built-in envs."""
