"""Serving: the NanoCP engine's main path."""
