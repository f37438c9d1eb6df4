"""Configurations of the port: the paper's logistic-regression task."""
