"""``python -m <package>.server`` — start the port's /generate server."""

from .app import main

if __name__ == "__main__":
    main()
