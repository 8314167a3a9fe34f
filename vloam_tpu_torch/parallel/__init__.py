"""Whole-trajectory back end: pose-graph optimisation and loop closure."""
