"""Slot-based continuous-batching serving engine."""
