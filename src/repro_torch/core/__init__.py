"""Closed-form VRR analysis and the accumulation policy (numpy only)."""
