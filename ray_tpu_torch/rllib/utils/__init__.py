"""RLlib utilities."""
