"""Samplers of the port: Hamiltonian annealed importance sampling."""

from .hais import HAIS

__all__ = ["HAIS"]
