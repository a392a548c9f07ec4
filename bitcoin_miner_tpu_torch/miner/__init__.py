"""Work units, dispatch and mining sessions."""
