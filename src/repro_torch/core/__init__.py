"""Decode-state core: caches, page selection, hybrid sparse attention."""
