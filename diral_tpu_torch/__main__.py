from diral_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
