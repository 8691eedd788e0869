"""The yardstick of the kernel stages: published peaks and the bytes each
stage has to move."""
