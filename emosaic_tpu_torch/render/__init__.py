"""Renderers: matched (repeat / randomize / greedy no-repeat) and global-greedy
no-repeat."""
