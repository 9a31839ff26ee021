"""Index construction, rank/LF, search and DP operations."""
