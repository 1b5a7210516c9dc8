"""``python -m <package>.server`` — start the port's model server (/generate
or /v2/models/{name}/infer, by the artifact's flavor)."""

from .app import main

if __name__ == "__main__":
    main()
