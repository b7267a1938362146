"""The host data path's native core (C++ behind ctypes, built with g++ at
first use): the cleaner, the hash and WordPiece batch encoders, the uint8
row gather and CRC32.  The Python paths in ``data/`` give the same bytes
and run where the library cannot be built."""
