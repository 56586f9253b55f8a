from audio_flamingo_tpu_torch.cli import main

if __name__ == "__main__":   # importing the module (pkgutil.walk_packages) runs nothing
    main()
