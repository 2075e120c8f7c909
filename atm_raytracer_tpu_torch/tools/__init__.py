"""The diagnostic subcommands: output-atm, output-ray-paths, output-elev-profile."""
