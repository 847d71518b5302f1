"""Kernels B2/B3 (Stream-K sweep, fix-up) and the policy composition."""
