"""Algorithms of the port: PPO, A2C, APPO, IMPALA, BC, MARWIL,
multi-agent PPO, ES and ARS."""
