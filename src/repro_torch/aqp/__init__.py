"""Approximate query processing: relation, sampler, queries, scan, plan."""
