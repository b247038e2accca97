"""Cost model the serving scheduler prices admission with."""

from .cost_model import CollectiveCostModel

__all__ = ["CollectiveCostModel"]
