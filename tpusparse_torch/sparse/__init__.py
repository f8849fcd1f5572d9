"""Stencil operators and the padded-resident layout."""
