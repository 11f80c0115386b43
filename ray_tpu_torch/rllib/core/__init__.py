"""RLModule / Learner core."""
