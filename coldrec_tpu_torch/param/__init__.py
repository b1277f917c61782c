"""Tools over the search driver's ``./param/`` directory."""
