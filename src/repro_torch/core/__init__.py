"""Verdict core: types, GP math, synopses, the store and the engine."""
