"""Kernels B2/B3 (the Stream-K sweep with its fix-up fused in), B5 and the policy composition."""
